"""The shape/size/axis grid of the transform routes, through the public API.

Every case runs a public entry point at the sizes and layouts that pick
distinct lowerings (power-of-two and mixed-radix Cooley-Tukey, Bluestein
primes, even/odd real transforms, the DCT/DST lowerings, minor / middle /
leading axes, partial batches), compares it with numpy/scipy in float64,
and asserts the route it compiled to through ``config.debug_plan_log``: a
change that silently moves a case onto another lowering fails here.

The ``test_pallas_*`` names date from the hand-written kernels these
shapes once selected. They are kept so each test's history can be
followed; no Pallas code runs here, every case goes through the XLA
engine.
"""

import numpy as np
import pytest
import scipy.fft

import jax.numpy as jnp
from ndrustfft_tpu import (
    DctHandler, FftHandler, Normalization, R2cFftHandler, config, nddct1,
    nddct2, nddct3, nddct4, ndfft, ndfft_r2c, ndifft, ndifft_r2c,
)
from ndrustfft_tpu.plan import get_c2c_plan


@pytest.fixture(autouse=True)
def _plan_log():
    # the eager jit cache is keyed on the config, so a fresh cache with the
    # log on retraces every call once and prints its route
    from ndrustfft_tpu.api import _jitted

    old = config.debug_plan_log
    config.debug_plan_log = True
    _jitted.cache_clear()
    yield
    config.debug_plan_log = old
    _jitted.cache_clear()


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [16, 64, 264, 1024])
def test_pallas_c2c_matches_numpy(n, capsys):
    rng = np.random.default_rng(n)
    x = _cplx(rng, (32, n))
    got = np.asarray(ndfft(jnp.asarray(x), FftHandler(n), axis=1))
    assert f"fft n={n} axis=1 -> engine-lane-last\n" in capsys.readouterr().err
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-4


def test_pallas_highest_precision_tier(capsys):
    # strict tier: f32-exact dots stay at f32-exact-level error
    from ndrustfft_tpu.api import _jitted

    old = config.matmul_precision
    config.matmul_precision = "highest"
    _jitted.cache_clear()
    try:
        rng = np.random.default_rng(77)
        n = 1024
        x = _cplx(rng, (32, n))
        got = np.asarray(ndfft(jnp.asarray(x), FftHandler(n), axis=1))
        assert "engine-lane-last" in capsys.readouterr().err
        assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-5
    finally:
        config.matmul_precision = old
        _jitted.cache_clear()


def test_pallas_partial_tile(capsys):
    # a batch that is no multiple of any tile width
    rng = np.random.default_rng(0)
    x = _cplx(rng, (37, 64))
    got = np.asarray(ndfft(jnp.asarray(x), FftHandler(64), axis=1))
    assert "fft n=64 axis=1 -> engine-lane-last" in capsys.readouterr().err
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-4


def test_pallas_inverse_and_r2c(capsys):
    rng = np.random.default_rng(1)
    x = _cplx(rng, (16, 128))
    h = FftHandler(128)
    back = np.asarray(ndifft(ndfft(jnp.asarray(x), h, 1), h, 1))
    assert np.abs(back - x).max() < 2e-4
    xr = rng.standard_normal((16, 128)).astype(np.float32)
    got = np.asarray(ndfft_r2c(jnp.asarray(xr), R2cFftHandler(128), axis=1))
    err = capsys.readouterr().err
    assert "ifft n=128 axis=1 -> engine-lane-last" in err
    assert "r2c n=128 axis=1 -> engine-r2c-half" in err
    assert _rel(got, np.fft.rfft(xr.astype(np.float64), axis=1)) < 1e-4


def test_pallas_matches_xla_engine_exactly_disabled():
    # the eager call and the same call traced into a user jit compile the
    # same engine program: identical values
    import jax

    rng = np.random.default_rng(2)
    x = _cplx(rng, (32, 64))
    h = FftHandler(64)
    a = np.asarray(ndfft(jnp.asarray(x), h, axis=1))
    b = np.asarray(jax.jit(lambda v: ndfft(v, h, axis=1))(jnp.asarray(x)))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_pallas_axis0_kernel(capsys):
    # transpose-free first-axis contraction (the 'einsum' axis-0 strategy)
    from ndrustfft_tpu.api import _jitted

    config.axis0_strategy = "einsum"
    _jitted.cache_clear()
    rng = np.random.default_rng(3)
    x = _cplx(rng, (264, 32))
    h = FftHandler(264)
    try:
        got = np.asarray(ndfft(jnp.asarray(x), h, axis=0))
        assert "fft n=264 axis=0 -> axis0-einsum" in capsys.readouterr().err
        assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=0)) < 1e-4
        back = np.asarray(ndifft(ndfft(jnp.asarray(x), h, 0), h, 0))
        assert np.abs(back - x).max() < 5e-4
    finally:
        config.axis0_strategy = "moveaxis"
        _jitted.cache_clear()


def test_pallas_fused_r2c_c2r(capsys):
    rng = np.random.default_rng(9)
    for n in [16, 264, 1024]:
        x = rng.standard_normal((32, n)).astype(np.float32)
        h = R2cFftHandler(n)
        got = np.asarray(ndfft_r2c(jnp.asarray(x), h, axis=1))
        assert _rel(got, np.fft.rfft(x.astype(np.float64), axis=1)) < 1e-4, n
        back = np.asarray(ndifft_r2c(jnp.asarray(got), h, axis=1))
        assert np.abs(back - x).max() < 5e-4, n
        err = capsys.readouterr().err
        assert f"r2c n={n} axis=1 -> engine-r2c-half" in err, err
        assert f"c2r n={n} axis=1 -> engine-c2r\n" in err, err


def test_pallas_fused_c2r_dc_nyquist_pin(capsys):
    rng = np.random.default_rng(10)
    n, m = 16, 9
    spec = _cplx(rng, (8, m))
    spec[:, 0] += 100j
    spec[:, -1] += 100j
    got = np.asarray(ndifft_r2c(jnp.asarray(spec), R2cFftHandler(n), axis=1))
    assert "c2r n=16 axis=1 -> engine-c2r" in capsys.readouterr().err
    ref = np.fft.irfft(spec.astype(np.complex128), n=n, axis=1)
    assert np.abs(got - ref).max() < 1e-4


def test_pallas_axis_mid_kernel(capsys):
    # middle axis of (B, n, L): power-of-two, mixed-radix and dense sizes
    rng = np.random.default_rng(11)
    for n in [16, 264, 384, 512, 1024]:
        x = _cplx(rng, (3, n, 40))
        h = FftHandler(n)
        got = np.asarray(ndfft(jnp.asarray(x), h, axis=1))
        err = capsys.readouterr().err
        assert f"fft n={n} axis=1 -> engine-lane-last+moveaxis" in err, err
        assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-4
        back = np.asarray(ndifft(ndfft(jnp.asarray(x), h, 1), h, 1))
        assert np.abs(back - x).max() < 5e-4, n


def test_pallas_axis_mid_partial_lane_tile(capsys):
    rng = np.random.default_rng(12)
    x = _cplx(rng, (2, 64, 37))
    got = np.asarray(ndfft(jnp.asarray(x), FftHandler(64), axis=1))
    assert "engine-lane-last+moveaxis" in capsys.readouterr().err
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-4


def test_pallas_fused_dct2_dct3(capsys):
    rng = np.random.default_rng(13)
    for n in [256, 1024]:
        x = rng.standard_normal((16, n)).astype(np.float32)
        x64 = x.astype(np.float64)
        h = DctHandler(n)
        got2 = np.asarray(nddct2(jnp.asarray(x), h, axis=1))
        assert _rel(got2, scipy.fft.dct(x64, type=2, axis=1)) < 1e-4, n
        got3 = np.asarray(nddct3(jnp.asarray(x), h, axis=1))
        assert _rel(got3, scipy.fft.dct(x64, type=3, axis=1)) < 1e-4, n
        err = capsys.readouterr().err
        assert f"dct2 n={n} axis=1 -> engine-dct\n" in err, err
        assert f"dct3 n={n} axis=1 -> engine-dct\n" in err, err
        # roundtrip: dct3(dct2(x)) = 2n x (scipy unnormalized identity)
        back = np.asarray(nddct3(nddct2(jnp.asarray(x), h, 1), h, 1))
        assert np.abs(back / (2.0 * n) - x).max() < 5e-4, n


def test_pallas_nat_c2r_dc_nyquist_pin_large_n(capsys):
    # DC/Nyquist imag zeroing and the 1/n normalization at n=1024
    rng = np.random.default_rng(12)
    n, m = 1024, 513
    spec = _cplx(rng, (16, m))
    spec[:, 0] += 100j     # DC imag garbage
    spec[:, -1] += 100j    # Nyquist imag garbage
    got = np.asarray(ndifft_r2c(jnp.asarray(spec), R2cFftHandler(n), axis=1))
    assert "c2r n=1024 axis=1 -> engine-c2r" in capsys.readouterr().err
    ref = np.fft.irfft(spec.astype(np.complex128), n=n, axis=1)
    assert np.abs(got - ref).max() < 5e-4


def test_pallas_nat_c2r_scalar_norm_fused(capsys):
    # the scalar normalization folds into the inverse's pre-step
    rng = np.random.default_rng(13)
    n, m = 1024, 513
    spec = _cplx(rng, (16, m))
    c = 0.37
    hs = R2cFftHandler(n).normalization(Normalization.scalar(c))
    got = np.asarray(ndifft_r2c(jnp.asarray(spec), hs, axis=1))
    assert "c2r n=1024 axis=1 -> engine-c2r" in capsys.readouterr().err
    s64 = spec.astype(np.complex128)
    s64[:, 0] = s64[:, 0].real
    s64[:, -1] = s64[:, -1].real
    ref = c * n * np.fft.irfft(s64, n=n, axis=1)
    assert _rel(got, ref) < 1e-3


def test_pallas_dct_scalar_norm_fused(capsys):
    # DCT norms fold into the lowering's constants (applied BEFORE the
    # transform per the reference, src/lib.rs:688-741)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((16, 512)).astype(np.float32)
    for t, fn in ((2, nddct2), (3, nddct3)):
        hs = DctHandler(512).normalization(Normalization.scalar(0.7))
        got = np.asarray(fn(jnp.asarray(x), hs, axis=1))
        assert f"dct{t} n=512 axis=1 -> engine-dct" in capsys.readouterr().err
        ref = 0.7 * scipy.fft.dct(x.astype(np.float64), type=t, axis=1) / 2
        assert _rel(got, ref) < 1e-3, t


def test_pallas_r2c_c2r_axis_mid(capsys):
    # r2c/c2r along axis 1 of (B, n, L)
    rng = np.random.default_rng(15)
    for n in [512, 1024]:
        x = rng.standard_normal((3, n, 16)).astype(np.float32)
        h = R2cFftHandler(n)
        got = np.asarray(ndfft_r2c(jnp.asarray(x), h, axis=1))
        assert _rel(got, np.fft.rfft(x.astype(np.float64), axis=1)) < 1e-4, n
        back = np.asarray(ndifft_r2c(jnp.asarray(got), h, axis=1))
        assert np.abs(back - x).max() < 5e-4, n
        err = capsys.readouterr().err
        assert f"r2c n={n} axis=1 -> engine-r2c-half+moveaxis" in err, err
        assert f"c2r n={n} axis=1 -> engine-c2r+moveaxis" in err, err
    # DC/Nyquist edge semantics on the middle axis
    n, m = 1024, 513
    spec = _cplx(rng, (2, m, 16))
    spec[:, 0, :] += 100j
    spec[:, -1, :] += 100j
    got = np.asarray(ndifft_r2c(jnp.asarray(spec), R2cFftHandler(n), axis=1))
    ref = np.fft.irfft(spec.astype(np.complex128), n=n, axis=1)
    assert np.abs(got - ref).max() < 5e-4


def test_pallas_dct_axis_mid(capsys):
    # DCT-II/III along axis 1 of (B, n, L)
    rng = np.random.default_rng(16)
    for n in [512, 1024]:
        x = rng.standard_normal((3, n, 16)).astype(np.float32)
        x64 = x.astype(np.float64)
        h = DctHandler(n)
        got2 = np.asarray(nddct2(jnp.asarray(x), h, axis=1))
        assert _rel(got2, scipy.fft.dct(x64, type=2, axis=1)) < 1e-4, n
        got3 = np.asarray(nddct3(jnp.asarray(x), h, axis=1))
        assert _rel(got3, scipy.fft.dct(x64, type=3, axis=1)) < 1e-4, n
        err = capsys.readouterr().err
        assert f"dct2 n={n} axis=1 -> engine-dct+moveaxis" in err, err
        assert f"dct3 n={n} axis=1 -> engine-dct+moveaxis" in err, err


@pytest.mark.parametrize("n,cols", [(2048, 256), (2304, 256), (1536, 200)])
def test_pallas_dct4_fused_mid(n, cols, capsys):
    # DCT-IV on the middle axis: a power of two, a 9-factor split and a
    # lane extent that is no multiple of 128
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, n, cols)).astype(np.float32)
    got = np.asarray(nddct4(jnp.asarray(x), DctHandler(n), axis=1))
    assert f"dct4 n={n} axis=1 -> engine-dct+moveaxis" in \
        capsys.readouterr().err
    ref = scipy.fft.dct(x.astype(np.float64), type=4, axis=1)
    assert _rel(got, ref) < 1e-4, (n, cols)


def test_pallas_dct3_unperm_in_kernel(capsys):
    # DCT-III's output un-permutation on the middle axis
    rng = np.random.default_rng(22)
    for n, cols in [(1024, 256), (2048, 200)]:
        x = rng.standard_normal((2, n, cols)).astype(np.float32)
        got = np.asarray(nddct3(jnp.asarray(x), DctHandler(n), axis=1))
        assert got.shape == x.shape
        assert f"dct3 n={n} axis=1 -> engine-dct+moveaxis" in \
            capsys.readouterr().err
        ref = scipy.fft.dct(x.astype(np.float64), type=3, axis=1)
        assert _rel(got, ref) < 1e-4, (n, cols)


def test_pallas_dct1_axis_mid(capsys):
    # DCT-I along axis 1 (extension length 2n-2)
    rng = np.random.default_rng(17)
    for n in [513, 1025]:
        x = rng.standard_normal((2, n, 16)).astype(np.float32)
        got = np.asarray(nddct1(jnp.asarray(x), DctHandler(n), axis=1))
        assert f"dct1 n={n} axis=1 -> engine-dct+moveaxis" in \
            capsys.readouterr().err
        ref = scipy.fft.dct(x.astype(np.float64), type=1, axis=1)
        assert _rel(got, ref) < 1e-4, n


def test_pallas_dct_dense_mid_all_types():
    # odd sizes (the reference's dct2d grid) and DCT-IV, all four types vs
    # scipy
    rng = np.random.default_rng(18)
    fns = {1: nddct1, 2: nddct2, 3: nddct3, 4: nddct4}
    for n in [129, 265]:
        x = rng.standard_normal((2, n, 16)).astype(np.float32)
        h = DctHandler(n)
        for k, fn in fns.items():
            got = np.asarray(fn(jnp.asarray(x), h, axis=1))
            ref = scipy.fft.dct(x.astype(np.float64), type=k, axis=1)
            assert _rel(got, ref) < 2e-4, (n, k)
    # even DCT-IV
    x = rng.standard_normal((2, 512, 16)).astype(np.float32)
    got = np.asarray(nddct4(jnp.asarray(x), DctHandler(512), axis=1))
    ref = scipy.fft.dct(x.astype(np.float64), type=4, axis=1)
    assert _rel(got, ref) < 2e-4


def test_pallas_rfft_dense_mid(capsys):
    # even n with an odd half length (n=264: h=132 = 4*3*11), incl. the
    # DC/Nyquist semantics
    rng = np.random.default_rng(19)
    for n in [128, 264]:
        x = rng.standard_normal((2, n, 16)).astype(np.float32)
        h = R2cFftHandler(n)
        got = np.asarray(ndfft_r2c(jnp.asarray(x), h, axis=1))
        assert _rel(got, np.fft.rfft(x.astype(np.float64), axis=1)) < 2e-4, n
        back = np.asarray(ndifft_r2c(jnp.asarray(got), h, axis=1))
        assert np.abs(back - x).max() < 1e-3, n
        assert f"r2c n={n} axis=1 -> engine-r2c-half+moveaxis" in \
            capsys.readouterr().err
    n, m = 264, 133
    spec = _cplx(rng, (2, m, 16))
    spec[:, 0, :] += 100j
    spec[:, -1, :] += 100j
    got = np.asarray(ndifft_r2c(jnp.asarray(spec), R2cFftHandler(n), axis=1))
    ref = np.fft.irfft(spec.astype(np.complex128), n=n, axis=1)
    assert np.abs(got - ref).max() < 1e-3


def test_pallas_fused_bluestein_mid(capsys):
    """Prime n on a non-minor axis rides the chirp-z lowering — rustfft
    any-n parity (src/lib.rs:295-297). Primes <= max_base_radix=128 plan
    as ct with a dense base, so the smallest Bluestein prime here is 131."""
    for n in (131, 509, 2053):
        plan = get_c2c_plan(n, -1)
        assert plan.kind == "bluestein"
        rng = np.random.default_rng(n)
        x = _cplx(rng, (2, n, 16))
        h = FftHandler(n)
        got = np.asarray(ndfft(jnp.asarray(x), h, axis=1))
        assert (f"fft n={n} axis=1 -> engine-bluestein(M={plan.M})+moveaxis"
                in capsys.readouterr().err)
        assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-4
        rt = np.asarray(ndifft(jnp.asarray(got), h, axis=1))
        assert np.abs(rt - x).max() < 1e-4


def test_pallas_fourstep_long_transform(capsys):
    """n = 2^17: a long transform through the multi-level engine
    recursion (SURVEY §5 long-context analog)."""
    n = 131072
    rng = np.random.default_rng(0)
    x = _cplx(rng, (2, n))
    h = FftHandler(n)
    got = np.asarray(ndfft(jnp.asarray(x), h, axis=1))
    assert f"fft n={n} axis=1 -> engine-lane-last" in capsys.readouterr().err
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-4
    rt = np.asarray(ndifft(jnp.asarray(got), h, axis=1))
    assert np.abs(rt - x).max() < 1e-3


def test_pallas_dct1_natural_mid(capsys):
    """DCT-I at n=2049 on the middle axis, with a scalar normalization."""
    n = 2049
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n, 16)).astype(np.float32)
    got = np.asarray(nddct1(jnp.asarray(x), DctHandler(n), axis=1))
    assert f"dct1 n={n} axis=1 -> engine-dct+moveaxis" in \
        capsys.readouterr().err
    ref = scipy.fft.dct(x.astype(np.float64), type=1, axis=1)
    assert _rel(got, ref) < 1e-4
    # scalar norm folds into the lowering's constants
    hs = DctHandler(n).normalization(Normalization.scalar(3.0))
    got3 = np.asarray(nddct1(jnp.asarray(x), hs, axis=1))
    assert np.abs(got3 - 1.5 * ref).max() / np.abs(ref).max() < 1e-4
