"""DCT 1-4 tests against live scipy oracles (reference src/lib.rs:1204-1407).

The reference pins hard-coded scipy.fft.dct goldens for the 6x6 fixture; here
the oracles are generated live, plus size sweeps, both axes, f32/f64, and the
normalization contract (Default == scipy; NONE == rustdct convention ==
scipy/2; Custom applied to the input lane before the transform).
"""

import numpy as np
import pytest
import scipy.fft as sf

import jax.numpy as jnp
from ndrustfft_tpu import DctHandler, Normalization, nddct1, nddct2, nddct3, nddct4

ND = {1: nddct1, 2: nddct2, 3: nddct3, 4: nddct4}


def fixture_matrix(n=6):
    return np.arange(n * n, dtype=np.float64).reshape(n, n)


@pytest.mark.parametrize("dct_type", [1, 2, 3, 4])
@pytest.mark.parametrize("axis", [0, 1])
def test_dct_2d_golden(dct_type, axis):
    v = fixture_matrix()
    h = DctHandler(6)
    got = np.asarray(ND[dct_type](jnp.asarray(v), h, axis=axis))
    ref = sf.dct(v, type=dct_type, axis=axis)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("dct_type", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 9, 16, 65, 100, 129, 257, 1025])
def test_dct_size_sweep(dct_type, n):
    rng = np.random.default_rng(n * 10 + dct_type)
    x = rng.standard_normal((3, n))
    h = DctHandler(n)
    got = np.asarray(ND[dct_type](jnp.asarray(x), h, axis=1))
    ref = sf.dct(x, type=dct_type, axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11 * np.abs(ref).max())


@pytest.mark.parametrize("dct_type", [2, 3, 4])
def test_dct_n1(dct_type):
    x = np.array([[3.25]])
    got = np.asarray(ND[dct_type](jnp.asarray(x), DctHandler(1), axis=1))
    ref = sf.dct(x, type=dct_type, axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_dct_norm_none_is_half_scipy():
    v = fixture_matrix()
    h = DctHandler(6).normalization(Normalization.NONE)
    got = np.asarray(nddct2(jnp.asarray(v), h, axis=0))
    ref = sf.dct(v, type=2, axis=0) / 2.0
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_dct_norm_custom_before_transform():
    # Custom fn applied to the input lane BEFORE the transform
    # (src/lib.rs:688-710): scaling input by 4 == scaling rustdct output by 4.
    v = fixture_matrix()
    h = DctHandler(6).normalization(Normalization.custom(lambda d: 4.0 * d))
    got = np.asarray(nddct3(jnp.asarray(v), h, axis=1))
    ref = 2.0 * sf.dct(v, type=3, axis=1)  # 4 * (scipy/2)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_dct2_dct3_duality():
    # DCT-III is the (scaled) inverse of DCT-II — the way the reference's
    # users express IDCT (SURVEY.md §3.5).
    n = 16
    x = np.random.default_rng(0).standard_normal(n)
    h = DctHandler(n)
    y = ND[2](jnp.asarray(x), h, 0)
    back = np.asarray(ND[3](y, h, 0)) / (2 * n)
    np.testing.assert_allclose(back, x, rtol=1e-11, atol=1e-12)


def test_dct_f32():
    n = 64
    x = np.random.default_rng(1).standard_normal((2, n)).astype(np.float32)
    got = np.asarray(nddct2(jnp.asarray(x), DctHandler(n), axis=1))
    ref = sf.dct(x.astype(np.float64), type=2, axis=1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_dct1_requires_n_ge_2():
    with pytest.raises(ValueError):
        nddct1(jnp.zeros((1,)), DctHandler(1), 0)


def test_size_mismatch_dct_message():
    with pytest.raises(ValueError, match=r"Size mismatch in dct, got 6 expected 5"):
        nddct2(jnp.zeros((6,)), DctHandler(5), 0)


def test_dct_complex_rejected():
    with pytest.raises(TypeError, match="real"):
        nddct2(jnp.zeros(6, jnp.complex128), DctHandler(6), 0)


def test_grad_through_dct():
    # differentiability across the DCT lowering (Makhoul + r2c composition):
    # finite-difference check per type (SURVEY §4 plan: functional
    # transforms are a framework capability the Rust reference lacks)
    import jax

    n = 12
    x = jnp.asarray(np.random.default_rng(40).standard_normal(n))
    for t, nd in ((1, nddct1), (2, nddct2), (3, nddct3), (4, nddct4)):
        h = DctHandler(n)

        def loss(v, _nd=nd, _h=h):
            return jnp.sum(jnp.abs(_nd(v, _h, 0)) ** 2)

        g = jax.grad(loss)(x)
        eps = 1e-6
        e0 = np.zeros(n)
        e0[5] = eps
        fd = (float(loss(x + e0)) - float(loss(x - e0))) / (2 * eps)
        np.testing.assert_allclose(float(g[5]), fd, rtol=1e-4,
                                   err_msg=f"dct type {t}")


def test_vmap_equivalence_dct():
    # serial == vmap over a leading batch dim, both DCT-II and DCT-I
    import jax

    rng = np.random.default_rng(41)
    x = jnp.asarray(rng.standard_normal((4, 3, 10)))
    for nd in (nddct1, nddct2):
        h = DctHandler(10)
        direct = np.asarray(nd(x, h, axis=2))
        mapped = np.asarray(jax.vmap(lambda v, _nd=nd, _h=h: _nd(v, _h, axis=1))(x))
        np.testing.assert_allclose(mapped, direct, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("n", [1283, 2049])
@pytest.mark.parametrize("dct_type", [2, 3])
def test_dct23_axis_mid_bluestein_kernel(n, dct_type):
    """Odd n whose FFT plans as Bluestein (2049 is the reference dct2d
    bench's odd twin) on the middle axis: the Makhoul lowering over the
    chirp-z C2C matches scipy, and a scalar normalization folds into the
    Makhoul twiddle."""
    from ndrustfft_tpu.plan import get_c2c_plan

    plan = get_c2c_plan(n, -1)
    assert plan.kind == "bluestein"
    rng = np.random.default_rng(n + dct_type)
    x = rng.standard_normal((2, n, 16)).astype(np.float32)
    h = DctHandler(n)
    got = np.asarray(ND[dct_type](jnp.asarray(x), h, axis=1))
    ref = sf.dct(x.astype(np.float64), type=dct_type, axis=1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    # scalar normalization folds into the Makhoul twiddle
    hs = DctHandler(n).normalization(Normalization.scalar(0.3))
    gots = np.asarray(ND[dct_type](jnp.asarray(x), hs, axis=1))
    assert np.abs(gots - 0.15 * ref).max() / np.abs(ref).max() < 1e-4
