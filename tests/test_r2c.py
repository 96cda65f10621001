"""R2C / C2R tests: numpy rfft/irfft oracles + the reference's edge pins.

Pins the two behavioral subtleties the reference fixed in 0.2.2 / 0.4.1
(CHANGELOG.md:33-38,58-63): DC/Nyquist imaginary parts are zeroed before the
inverse so non-Hermitian garbage matches numpy irfft, and odd-n roundtrips
normalize over the FULL length n.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from ndrustfft_tpu import (
    Normalization, R2cFftHandler, ndfft_r2c, ndfft_r2c_par, ndifft_r2c,
    ndifft_r2c_par,
)


def fixture_matrix(n=6):
    return np.arange(n * n, dtype=np.float64).reshape(n, n)


@pytest.mark.parametrize("axis", [0, 1])
def test_rfft_2d_golden(axis):
    v = fixture_matrix()
    h = R2cFftHandler(6)
    got = np.asarray(ndfft_r2c(jnp.asarray(v), h, axis=axis))
    ref = np.fft.rfft(v, axis=axis)
    assert got.shape == ref.shape  # m = n//2+1 on the transformed axis
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 16, 17, 100, 101, 127,
                               263, 264, 509, 1024])
def test_rfft_size_sweep_and_roundtrip(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n))
    h = R2cFftHandler(n)
    got = np.asarray(ndfft_r2c(jnp.asarray(x), h, axis=1))
    ref = np.fft.rfft(x, axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11 * max(1, np.abs(ref).max()))
    back = np.asarray(ndifft_r2c(jnp.asarray(got), h, axis=1))
    np.testing.assert_allclose(back, x, rtol=1e-11, atol=1e-11)


def test_rfft_odd_roundtrip():
    # reference test_fft_r2c_odd (src/lib.rs:1169-1202): the 0.4.1 odd-n fix
    n = 7
    x = np.arange(n, dtype=np.float64)
    h = R2cFftHandler(n)
    back = np.asarray(ndifft_r2c(ndfft_r2c(jnp.asarray(x), h, 0), h, 0))
    np.testing.assert_allclose(back, x, rtol=1e-12, atol=1e-12)


def test_ifft_c2r_first_last_element():
    # reference test_ifft_c2r_first_last_element (src/lib.rs:1136-1167):
    # garbage imaginary parts on the DC and Nyquist bins must be ignored,
    # matching numpy irfft.
    n = 6
    m = n // 2 + 1
    rng = np.random.default_rng(0)
    spec = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    spec[0] += 100j
    spec[m - 1] += 100j
    h = R2cFftHandler(n)
    got = np.asarray(ndifft_r2c(jnp.asarray(spec), h, 0))
    ref = np.fft.irfft(spec, n=n)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_ifft_c2r_odd_dc_imag_only():
    # odd n: only the DC imaginary part is zeroed (src/lib.rs:516-521)
    n = 7
    m = n // 2 + 1
    rng = np.random.default_rng(1)
    spec = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    spec[0] += 50j
    h = R2cFftHandler(n)
    got = np.asarray(ndifft_r2c(jnp.asarray(spec), h, 0))
    ref = np.fft.irfft(spec, n=n)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_c2r_norm_none_scales_by_n():
    n = 8
    x = np.random.default_rng(2).standard_normal(n)
    h = R2cFftHandler(n).normalization(Normalization.NONE)
    back = np.asarray(ndifft_r2c(ndfft_r2c(jnp.asarray(x), h, 0), h, 0))
    np.testing.assert_allclose(back, n * x, rtol=1e-12)


def test_c2r_norm_custom_applied_before_inverse():
    n = 8
    x = np.random.default_rng(3).standard_normal(n)
    h = R2cFftHandler(n).normalization(
        Normalization.custom(lambda s: s * (2.0 / n))
    )
    back = np.asarray(ndifft_r2c(ndfft_r2c(jnp.asarray(x), h, 0), h, 0))
    np.testing.assert_allclose(back, 2 * x, rtol=1e-12)


def test_r2c_par_equivalence():
    v = fixture_matrix()
    h = R2cFftHandler(6)
    a = np.asarray(ndfft_r2c(jnp.asarray(v), h, axis=0))
    b = np.asarray(ndfft_r2c_par(jnp.asarray(v), h, axis=0))
    np.testing.assert_array_equal(a, b)


def test_rfft2_pipeline():
    # canonical multi-dim real pipeline (examples/rfft2.rs:29-33): r2c along
    # the LAST axis, then C2C along axis 0 on the half-spectrum.
    from ndrustfft_tpu import FftHandler, ndfft

    v = fixture_matrix()
    hr = R2cFftHandler(6)
    hc = FftHandler(6)
    vhat = ndfft(ndfft_r2c(jnp.asarray(v), hr, axis=1), hc, axis=0)
    ref = np.fft.fft(np.fft.rfft(v, axis=1), axis=0)
    np.testing.assert_allclose(np.asarray(vhat), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_r2c_complex_input_rejected():
    with pytest.raises(TypeError, match="real"):
        ndfft_r2c(jnp.zeros(6, jnp.complex128), R2cFftHandler(6), 0)


def test_size_mismatch_r2c():
    h = R2cFftHandler(8)  # m = 5
    with pytest.raises(ValueError, match="Size mismatch in fft, got 8 expected 5"):
        ndifft_r2c(jnp.zeros(8, jnp.complex128), h, 0)


def test_f32_precision():
    n = 64
    x = np.random.default_rng(5).standard_normal((4, n)).astype(np.float32)
    got = np.asarray(ndfft_r2c(jnp.asarray(x), R2cFftHandler(n), axis=1))
    ref = np.fft.rfft(x.astype(np.float64), axis=1)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_odd_n_dense_kernel_routing_and_semantics():
    """Odd-n R2C/C2R on the middle axis takes the odd (no half-length pack)
    engine route; odd n has no Nyquist bin, DC imag is still masked
    (reference src/lib.rs:516-521)."""
    from ndrustfft_tpu.plan import get_r2c_plan

    for n in (129, 1025):
        assert not get_r2c_plan(n).half
        rng = np.random.default_rng(n)
        x = rng.standard_normal((2, n, 16)).astype(np.float32)
        h = R2cFftHandler(n)
        s = np.asarray(ndfft_r2c(jnp.asarray(x), h, axis=1))
        ref = np.fft.rfft(x.astype(np.float64), axis=1)
        assert np.abs(s - ref).max() / np.abs(ref).max() < 1e-4
        # DC imag garbage must not change the inverse (odd: no Nyquist)
        s2 = s.astype(np.complex64)
        s2[:, 0, :] += 100j
        rt = np.asarray(ndifft_r2c(jnp.asarray(s2), h, axis=1))
        assert np.abs(rt - x).max() < 1e-3


def test_vmap_equivalence_r2c():
    # serial == vmap (SURVEY §4 plan) across the R2C pack and C2R unpack
    import jax

    from ndrustfft_tpu import ndifft_r2c

    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.standard_normal((5, 3, 14)))
    h = R2cFftHandler(14)
    direct = ndfft_r2c(x, h, axis=2)
    mapped = jax.vmap(lambda v: ndfft_r2c(v, h, axis=1))(x)
    np.testing.assert_allclose(np.asarray(mapped), np.asarray(direct),
                               rtol=1e-11, atol=1e-11)
    back_d = np.asarray(ndifft_r2c(direct, h, axis=2))
    back_m = np.asarray(jax.vmap(lambda v: ndifft_r2c(v, h, axis=1))(mapped))
    np.testing.assert_allclose(back_m, back_d, rtol=1e-11, atol=1e-11)
