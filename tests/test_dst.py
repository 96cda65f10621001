"""DST 1-4 tests against live scipy oracles — beyond-parity extension.

The reference exposes DCT only (src/lib.rs:613-844); its rustdct backend
also ships DST 1-4, which this build completes (ops/dst.py). Same contract
shape as test_dct.py: live scipy.fft.dst oracles, size sweeps including odd
and prime lengths, both axes, f32/f64, the normalization contract (Default
== scipy; NONE == rustdct convention == scipy/2; Custom applied to the
input lane before the transform), handler plumbing, grad/vmap, and the
_par twins (serial equivalence + sharded pencil routing).
"""

import numpy as np
import pytest
import scipy.fft as sf

import jax
import jax.numpy as jnp
from ndrustfft_tpu import (
    DstHandler, Normalization, nddst1, nddst2, nddst3, nddst4,
    nddst1_par, nddst2_par, nddst3_par, nddst4_par,
)

ND = {1: nddst1, 2: nddst2, 3: nddst3, 4: nddst4}
ND_PAR = {1: nddst1_par, 2: nddst2_par, 3: nddst3_par, 4: nddst4_par}


def fixture_matrix(n=6):
    return np.arange(n * n, dtype=np.float64).reshape(n, n)


@pytest.mark.parametrize("dst_type", [1, 2, 3, 4])
@pytest.mark.parametrize("axis", [0, 1])
def test_dst_2d_golden(dst_type, axis):
    v = fixture_matrix()
    h = DstHandler(6)
    got = np.asarray(ND[dst_type](jnp.asarray(v), h, axis=axis))
    ref = sf.dst(v, type=dst_type, axis=axis)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("dst_type", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9, 16, 65, 100, 129, 257, 1025])
def test_dst_size_sweep(dst_type, n):
    rng = np.random.default_rng(n * 10 + dst_type)
    x = rng.standard_normal((3, n))
    got = np.asarray(ND[dst_type](jnp.asarray(x), DstHandler(n), axis=1))
    ref = sf.dst(x, type=dst_type, axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("dst_type", [1, 2, 3, 4])
def test_dst_f32(dst_type):
    rng = np.random.default_rng(7 + dst_type)
    x = rng.standard_normal((4, 96)).astype(np.float32)
    got = np.asarray(ND[dst_type](jnp.asarray(x)))
    ref = sf.dst(x.astype(np.float64), type=dst_type)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dst_type", [1, 2, 3, 4])
def test_dst_normalization_contract(dst_type):
    rng = np.random.default_rng(40 + dst_type)
    n = 24
    x = rng.standard_normal((2, n))
    ref = sf.dst(x, type=dst_type, axis=1)
    xj = jnp.asarray(x)
    # Default == scipy
    np.testing.assert_allclose(
        np.asarray(ND[dst_type](xj, DstHandler(n))), ref, atol=1e-11, rtol=1e-11)
    # NONE == rustdct convention == scipy/2
    h = DstHandler(n).normalization(Normalization.NONE)
    np.testing.assert_allclose(
        np.asarray(ND[dst_type](xj, h)), ref / 2, atol=1e-11, rtol=1e-11)
    # scalar(c) == c * rustdct convention
    h = DstHandler(n).normalization(Normalization.scalar(3.0))
    np.testing.assert_allclose(
        np.asarray(ND[dst_type](xj, h)), 1.5 * ref, atol=1e-10, rtol=1e-10)
    # custom fn applied to the input lane BEFORE the transform
    h = DstHandler(n).normalization(Normalization.custom(lambda v: 2.0 * v))
    np.testing.assert_allclose(
        np.asarray(ND[dst_type](xj, h)), ref, atol=1e-11, rtol=1e-11)


@pytest.mark.parametrize("dst_type", [1, 2, 3, 4])
def test_dst_3d_middle_axis(dst_type):
    rng = np.random.default_rng(50 + dst_type)
    x = rng.standard_normal((3, 10, 4))
    got = np.asarray(ND[dst_type](jnp.asarray(x), DstHandler(10), axis=1))
    ref = sf.dst(x, type=dst_type, axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11 * np.abs(ref).max())


def test_dst_errors():
    x = jnp.ones((4, 8))
    with pytest.raises(ValueError, match="Size mismatch"):
        nddst2(x, DstHandler(9), axis=1)
    with pytest.raises(TypeError, match="real"):
        nddst2(jnp.ones((4, 8), dtype=jnp.complex64), DstHandler(8), axis=1)


@pytest.mark.parametrize("dst_type", [1, 2, 3, 4])
def test_dst_grad(dst_type):
    """DSTs are linear: the VJP of sum(DST(x)) equals DST^T(ones), which the
    identities must propagate without materializing anything odd. Checked
    against a numerical directional derivative."""
    rng = np.random.default_rng(60 + dst_type)
    n = 12
    x = jnp.asarray(rng.standard_normal((2, n)))
    v = jnp.asarray(rng.standard_normal((2, n)))
    f = lambda a: jnp.sum(jnp.sin(ND[dst_type](a, DstHandler(n))))
    g = jax.grad(f)(x)
    eps = 1e-6
    num = (f(x + eps * v) - f(x - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(g, v)), float(num), rtol=1e-4)


@pytest.mark.parametrize("dst_type", [1, 2, 3, 4])
def test_dst_vmap_equals_serial(dst_type):
    rng = np.random.default_rng(70 + dst_type)
    x = jnp.asarray(rng.standard_normal((5, 3, 16)))
    h = DstHandler(16)
    f = lambda a: ND[dst_type](a, h, axis=-1)
    got = jax.vmap(f)(x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(f(x)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dst_type", [1, 2, 3, 4])
def test_dst_par_unsharded_equals_serial(dst_type):
    rng = np.random.default_rng(80 + dst_type)
    x = jnp.asarray(rng.standard_normal((4, 18)))
    a = np.asarray(ND_PAR[dst_type](x, DstHandler(18), axis=1))
    b = np.asarray(ND[dst_type](x, DstHandler(18), axis=1))
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dst_type", [1, 2, 3, 4])
def test_dst_par_sharded_pencil(dst_type):
    """Sharded input routes through the pencil path and matches scipy,
    including when the transform axis itself is sharded (all_to_all
    re-sharding)."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("px", "py"))
    rng = np.random.default_rng(90 + dst_type)
    x = rng.standard_normal((8, 12, 4))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("px", "py")))
    got = np.asarray(ND_PAR[dst_type](xs, DstHandler(12), axis=1))
    ref = sf.dst(x, type=dst_type, axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("n", [255, 511, 1023, 512, 1024])
def test_dst1_packed_mid_kernel(n):
    """DST-I on the middle axis runs the packed odd-extension lowering (no
    2n+2 intermediate) and matches scipy for odd and even n alike: the
    extension length 2n+2 has half h = n+1, so both parities of the half
    length are pinned here."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n, 8)).astype(np.float32)
    ref = sf.dst(x.astype(np.float64), type=1, axis=1)
    got = np.asarray(nddst1(jnp.asarray(x), DstHandler(n), axis=1))
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-4, err
