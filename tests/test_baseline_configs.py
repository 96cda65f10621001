"""The five BASELINE.json driver configs, end-to-end (CPU, scaled where a
full-size run would be too slow for CI — full sizes run on the GPU via chip_smoke.py and bench.py).
"""

import numpy as np
import pytest
import scipy.fft as sf

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ndrustfft_tpu import (
    DctHandler, FftHandler, Normalization, R2cFftHandler, nddct1, nddct2,
    nddct3, nddct4, ndfft, ndfft_r2c, ndifft,
)


def test_config1_readme_rfft2_6x4_f64_axis0():
    # "2-D R2C FFT, 6x4 f64 along axis 0" (BASELINE.json config #1)
    v = np.arange(24, dtype=np.float64).reshape(6, 4)
    got = np.asarray(ndfft_r2c(jnp.asarray(v), R2cFftHandler(6), axis=0))
    ref = np.fft.rfft(v, axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_config2_1d_c2c_1024_roundtrip():
    # "1-D C2C fft->ifft roundtrip, 1024-point, scipy-normalized"
    rng = np.random.default_rng(0)
    v = rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
    h = FftHandler(1024)
    vhat = ndfft(jnp.asarray(v), h, axis=0)
    np.testing.assert_allclose(np.asarray(vhat), sf.fft(v), rtol=1e-11,
                               atol=1e-11 * np.abs(v).max() * 1024)
    back = np.asarray(ndifft(vhat, h, axis=0))
    np.testing.assert_allclose(back, v, rtol=1e-11, atol=1e-12)


def test_config3_2d_c2c_512_both_axes_norms():
    # "2-D C2C FFT along both axes, 512x512, default vs custom Normalization"
    rng = np.random.default_rng(1)
    n = 512
    v = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = FftHandler(n)
    vhat = ndfft(ndfft(jnp.asarray(v), h, axis=1), h, axis=0)
    ref = np.fft.fft2(v)
    np.testing.assert_allclose(np.asarray(vhat), ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())
    # default norm roundtrip == identity; custom (2/n) roundtrip == 4x
    h_c = FftHandler(n).normalization(
        Normalization.custom(lambda d: d * (2.0 / d.shape[-1])))
    back = np.asarray(ndifft(ndifft(vhat, h, axis=0), h, axis=1))
    np.testing.assert_allclose(back, v, rtol=1e-10, atol=1e-11)
    back_c = np.asarray(ndifft(ndifft(
        ndfft(ndfft(jnp.asarray(v), h_c, 1), h_c, 0), h_c, 0), h_c, 1))
    np.testing.assert_allclose(back_c, 4 * v, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dct_type", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 2e-4), (np.float64, 1e-10)])
def test_config4_dct_batched_1024_axis1(dct_type, dtype, rtol):
    # "DCT-1/2/3/4 batched along axis 1 of 1024(x64) f32/f64 real arrays"
    # (batch dim scaled from 1024 to 64 rows for CI time; axis length 1024)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 1024)).astype(dtype)
    fn = {1: nddct1, 2: nddct2, 3: nddct3, 4: nddct4}[dct_type]
    got = np.asarray(fn(jnp.asarray(x), DctHandler(1024), axis=1))
    ref = sf.dct(x.astype(np.float64), type=dct_type, axis=1)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_config5_3d_r2c_pencil_pipeline():
    # "3-D R2C 256^3 pencil-decomposed spectral pipeline sharded over a
    # device mesh" — run at 64^3 on the virtual 8-device mesh (full size
    # on four GPUs: chip_smoke.py --four)
    from ndrustfft_tpu.parallel import irfftn_pencil, rfftn_pencil

    rng = np.random.default_rng(3)
    n = 64
    v = rng.standard_normal((n, n, n)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("y", "z"))
    x = jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("y", "z", None)))

    @jax.jit
    def spectral_step(u):
        uhat, spec = rfftn_pencil(u, mesh, P("y", "z", None))
        # spectral multiplier (Poisson-style), then back
        uhat = uhat * 0.5
        return irfftn_pencil(uhat, mesh, spec, n_last=n, axes=[0, 1, 2])[0]

    out = np.asarray(spectral_step(x))
    np.testing.assert_allclose(out, 0.5 * v, rtol=1e-4, atol=1e-5)
