"""ndspectral_r2c — the fused r2c -> diagonal multiply -> c2r pipeline.

Contract: exactly ``ndifft_r2c(mult * ndfft_r2c(x, h, axis), h, axis)``
(reference inverse semantics: normalization before the inverse, DC/Nyquist
imag zeroing — src/lib.rs:506-523) with the three steps traced into ONE
program. These tests pin the fused step against the public composition and
a numpy oracle across odd n, the minor axis, full-shape multipliers and
custom normalization, and full AD in both modes and both arguments (the map
is bilinear).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from ndrustfft_tpu import (
    Normalization, R2cFftHandler, ndfft_r2c, ndifft_r2c, ndspectral_r2c,
)


def _oracle(x, H, n, axis, scale=None):
    S = np.fft.rfft(x.astype(np.float64), axis=axis)
    shp = [1] * x.ndim
    shp[axis] = S.shape[axis]
    S = S * np.asarray(H, np.complex128).reshape(shp)
    S = S * (1.0 / n if scale is None else scale)
    # reference inverse pre-steps: zero DC (and even-n Nyquist) imag
    sl = [slice(None)] * x.ndim
    sl[axis] = 0
    S[tuple(sl)] = S[tuple(sl)].real
    if n % 2 == 0:
        sl[axis] = -1
        S[tuple(sl)] = S[tuple(sl)].real
    return np.fft.irfft(S, n=n, axis=axis) * n


@pytest.fixture(autouse=True)
def _fresh_caches():
    from ndrustfft_tpu.api import _jitted, _spectral_jitted

    _jitted.cache_clear()
    _spectral_jitted.cache_clear()
    yield


@pytest.mark.parametrize("n", [512, 1024])
def test_fused_kernel_matches_oracle(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n, 16)).astype(np.float32)
    m = n // 2 + 1
    H = (rng.standard_normal(m)
         + 1j * rng.standard_normal(m)).astype(np.complex64)
    got = np.asarray(ndspectral_r2c(jnp.asarray(x), jnp.asarray(H),
                                    R2cFftHandler(n), axis=1))
    ref = _oracle(x, H, n, 1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_fused_equals_public_composition():
    n, m = 512, 257
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, n, 16)).astype(np.float32))
    H = jnp.asarray((rng.standard_normal(m)
                     + 1j * rng.standard_normal(m)).astype(np.complex64))
    h = R2cFftHandler(n)
    got = ndspectral_r2c(x, H, h, axis=1)
    ref = ndifft_r2c(H.reshape(1, m, 1) * ndfft_r2c(x, h, axis=1), h, axis=1)
    assert float(jnp.abs(got - ref).max()) < 2e-4


def test_real_multiplier_and_scalar_norm():
    n, m = 512, 257
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, n, 16)).astype(np.float32)
    H = rng.standard_normal(m).astype(np.float32)
    h = R2cFftHandler(n).normalization(Normalization.scalar(3.0 / n))
    got = np.asarray(ndspectral_r2c(jnp.asarray(x), jnp.asarray(H), h,
                                    axis=1))
    ref = _oracle(x, H, n, 1, scale=3.0 / n)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize("case", ["odd_n", "minor_axis", "full_mult"])
def test_fallback_routes(case):
    rng = np.random.default_rng(3)
    n = 511 if case == "odd_n" else 64
    axis = 2 if case == "minor_axis" else 1
    shape = (3, n, 8) if axis == 1 else (3, 8, n)
    m = n // 2 + 1
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "full_mult":
        mshape = list(shape)
        mshape[axis] = m
        H = (rng.standard_normal(mshape)
             + 1j * rng.standard_normal(mshape)).astype(np.complex64)
    else:
        H = (rng.standard_normal(m)
             + 1j * rng.standard_normal(m)).astype(np.complex64)
    h = R2cFftHandler(n)
    got = np.asarray(ndspectral_r2c(jnp.asarray(x), jnp.asarray(H), h,
                                    axis=axis))
    if case == "full_mult":
        ref = np.asarray(ndifft_r2c(
            jnp.asarray(H) * ndfft_r2c(jnp.asarray(x), h, axis=axis),
            h, axis=axis))
    else:
        ref = _oracle(x, H, n, axis)
    assert np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-9) < 1e-4


def test_custom_normalization_fallback():
    rng = np.random.default_rng(4)
    n, m = 64, 33
    x = rng.standard_normal((2, n, 8)).astype(np.float32)
    H = rng.standard_normal(m).astype(np.float32)
    h = R2cFftHandler(n).normalization(
        Normalization.custom(lambda v: v / n))
    got = np.asarray(ndspectral_r2c(jnp.asarray(x), jnp.asarray(H), h,
                                    axis=1))
    ref = _oracle(x, H, n, 1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_dc_passthrough_doc_contract():
    # constant signal + DC-keeping filter: identity
    x = jnp.ones((4, 8))
    keep = jnp.asarray([1.0, 1.0, 0.0, 0.0, 0.0])
    y = ndspectral_r2c(x, keep, R2cFftHandler(8), axis=1)
    assert float(jnp.abs(y - x).max()) < 1e-5


def test_ad_both_modes_both_args():
    n, m = 512, 257
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((1, n, 16)).astype(np.float32))
    H = jnp.asarray((rng.standard_normal(m)
                     + 1j * rng.standard_normal(m)).astype(np.complex64))
    h = R2cFftHandler(n)

    def loss(v, hm):
        return jnp.sum(ndspectral_r2c(v, hm, h, axis=1) ** 2)

    def loss_engine(v, hm):
        y = ndifft_r2c(hm.reshape(1, m, 1) * ndfft_r2c(v, h, axis=1),
                       h, axis=1)
        return jnp.sum(y ** 2)

    gx = jax.grad(loss)(x, H)
    gx_ref = jax.grad(loss_engine)(x, H)
    assert float(jnp.abs(gx - gx_ref).max()) < 2e-3
    gh = jax.grad(loss, argnums=1)(x, H)
    gh_ref = jax.grad(loss_engine, argnums=1)(x, H)
    assert float(jnp.abs(gh - gh_ref).max()) < 2e-3
    # forward mode through x (linearity: jvp == transform of tangent)
    tv = jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
    _, ty = jax.jvp(lambda v: ndspectral_r2c(v, H, h, axis=1), (x,), (tv,))
    ty_ref = ndspectral_r2c(tv, H, h, axis=1)
    assert float(jnp.abs(ty - ty_ref).max()) < 2e-4


def test_under_user_jit():
    n, m = 512, 257
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((1, n, 16)).astype(np.float32))
    H = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    h = R2cFftHandler(n)

    @jax.jit
    def step(v, hm):
        return ndspectral_r2c(v, hm, h, axis=1)

    got = np.asarray(step(x, H))
    ref = _oracle(np.asarray(x), np.asarray(H), n, 1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


# ---- ndspectral_dct: the cosine-basis (Neumann) twin ----


def test_dct_fused_kernel_matches_scipy():
    import scipy.fft as sp

    from ndrustfft_tpu import DctHandler, nddct2, nddct3, ndspectral_dct

    n = 1024
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, n, 16)).astype(np.float32)
    H = rng.standard_normal(n).astype(np.float32)
    h2 = DctHandler(n).normalization(Normalization.NONE)
    h3 = DctHandler(n).normalization(Normalization.scalar(2.0 / n))
    got = np.asarray(ndspectral_dct(jnp.asarray(x), jnp.asarray(H), h2, h3,
                                    axis=1))
    y2 = sp.dct(x.astype(np.float64), type=2, axis=1) / 2
    ref = sp.dct((2.0 / n) * H[None, :, None] * y2, type=3, axis=1) / 2
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    # and the fused route equals the public composition bit-for-tolerance
    comp = np.asarray(nddct3(
        jnp.asarray(H).reshape(1, n, 1)
        * nddct2(jnp.asarray(x), h2, axis=1), h3, axis=1))
    assert np.abs(got - comp).max() < 2e-4 * np.abs(comp).max()


def test_dct_fallback_routes_and_identity():
    from ndrustfft_tpu import DctHandler, ndspectral_dct

    rng = np.random.default_rng(11)
    # odd n + minor axis fall back to the composition
    for n, ax in ((511, 1), (64, 1)):
        x = rng.standard_normal((2, n, 8) if ax == 1 else (2, 8, n)
                                ).astype(np.float32)
        h2 = DctHandler(n).normalization(Normalization.NONE)
        h3 = DctHandler(n).normalization(
            Normalization.scalar(2.0 / n))
        y = np.asarray(ndspectral_dct(jnp.asarray(x), jnp.ones(n), h2, h3,
                                      axis=ax))
        assert np.abs(y - x).max() < 1e-4  # dct3(dct2(x)) * 2/n = x


def test_dct_complex_multiplier_raises():
    from ndrustfft_tpu import DctHandler, ndspectral_dct

    x = jnp.ones((2, 64))
    with pytest.raises(TypeError):
        ndspectral_dct(x, jnp.ones(64, jnp.complex64), DctHandler(64),
                       axis=1)


def test_dct_ad_both_modes():
    from ndrustfft_tpu import DctHandler, nddct2, nddct3, ndspectral_dct

    n = 512
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal((1, n, 16)).astype(np.float32))
    H = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    h2 = DctHandler(n).normalization(Normalization.NONE)
    h3 = DctHandler(n).normalization(Normalization.scalar(2.0 / n))

    def loss(v, hm):
        return jnp.sum(ndspectral_dct(v, hm, h2, h3, axis=1) ** 2)

    def loss_engine(v, hm):
        y = nddct3(hm.reshape(1, n, 1) * nddct2(v, h2, axis=1), h3,
                   axis=1)
        return jnp.sum(y ** 2)

    for arg in (0, 1):
        g = jax.grad(loss, argnums=arg)(x, H)
        g_ref = jax.grad(loss_engine, argnums=arg)(x, H)
        assert float(jnp.abs(g - g_ref).max()) < 2e-3
    tv = jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
    _, ty = jax.jvp(lambda v: ndspectral_dct(v, H, h2, h3, axis=1),
                    (x,), (tv,))
    ty_ref = ndspectral_dct(tv, H, h2, h3, axis=1)
    assert float(jnp.abs(ty - ty_ref).max()) < 2e-4


# ---- ndspectral_c2c: the complex member of the fused family ----


def test_c2c_fused_kernel_matches_numpy():
    from ndrustfft_tpu import FftHandler, ndspectral_c2c

    n = 1024
    rng = np.random.default_rng(20)
    x = (rng.standard_normal((2, n, 16))
         + 1j * rng.standard_normal((2, n, 16))).astype(np.complex64)
    H = (rng.standard_normal(n)
         + 1j * rng.standard_normal(n)).astype(np.complex64)
    got = np.asarray(ndspectral_c2c(jnp.asarray(x), jnp.asarray(H),
                                    FftHandler(n), axis=1))
    ref = np.fft.ifft(np.asarray(H).reshape(1, n, 1)
                      * np.fft.fft(x.astype(np.complex128), axis=1), axis=1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-4


def test_c2c_fused_equals_public_composition():
    from ndrustfft_tpu import FftHandler, ndfft, ndifft, ndspectral_c2c

    n = 512
    rng = np.random.default_rng(21)
    x = jnp.asarray((rng.standard_normal((2, n, 16))
                     + 1j * rng.standard_normal((2, n, 16))
                     ).astype(np.complex64))
    H = jnp.asarray((rng.standard_normal(n)
                     + 1j * rng.standard_normal(n)).astype(np.complex64))
    h = FftHandler(n).normalization(Normalization.scalar(3.0 / n))
    got = ndspectral_c2c(x, H, h, axis=1)
    ref = ndifft(H.reshape(1, n, 1) * ndfft(x, h, axis=1), h, axis=1)
    assert float(jnp.abs(got - ref).max()) < 2e-4 * float(jnp.abs(ref).max())


def test_c2c_fallbacks():
    from ndrustfft_tpu import FftHandler, ndspectral_c2c

    rng = np.random.default_rng(22)
    # no-twostep n (264: dense body) and minor axis fall back
    for n, ax in ((264, 1), (64, 2)):
        shape = (2, n, 8) if ax == 1 else (2, 8, n)
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        H = np.ones(n, np.float32)
        y = np.asarray(ndspectral_c2c(jnp.asarray(x), jnp.asarray(H),
                                      FftHandler(n), axis=ax))
        assert np.abs(y - x).max() < 1e-4  # roundtrip identity


def test_c2c_ad_both_modes():
    from ndrustfft_tpu import FftHandler, ndfft, ndifft, ndspectral_c2c

    n = 512
    rng = np.random.default_rng(23)
    x = jnp.asarray((rng.standard_normal((1, n, 16))
                     + 1j * rng.standard_normal((1, n, 16))
                     ).astype(np.complex64))
    H = jnp.asarray((rng.standard_normal(n)
                     + 1j * rng.standard_normal(n)).astype(np.complex64))
    h = FftHandler(n)

    def loss(v, hm):
        return jnp.sum(jnp.abs(ndspectral_c2c(v, hm, h, axis=1)) ** 2)

    def loss_engine(v, hm):
        y = ndifft(hm.reshape(1, n, 1) * ndfft(v, h, axis=1), h, axis=1)
        return jnp.sum(jnp.abs(y) ** 2)

    for arg in (0, 1):
        g = jax.grad(loss, argnums=arg)(x, H)
        g_ref = jax.grad(loss_engine, argnums=arg)(x, H)
        assert float(jnp.abs(g - g_ref).max()) < 3e-3
    tv = jnp.ones_like(x)
    _, ty = jax.jvp(lambda v: ndspectral_c2c(v, H, h, axis=1), (x,), (tv,))
    ty_ref = ndspectral_c2c(tv, H, h, axis=1)
    assert float(jnp.abs(ty - ty_ref).max()) < 3e-4


# ---- ndspectral_dst: the sine-basis (Dirichlet) member ----


def test_dst_fused_matches_scipy_and_composition():
    import scipy.fft as sp

    from ndrustfft_tpu import DstHandler, nddst2, nddst3, ndspectral_dst

    n = 512
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, n, 16)).astype(np.float32)
    H = rng.standard_normal(n).astype(np.float32)
    h2 = DstHandler(n).normalization(Normalization.NONE)
    h3 = DstHandler(n).normalization(Normalization.scalar(2.0 / n))
    got = np.asarray(ndspectral_dst(jnp.asarray(x), jnp.asarray(H), h2, h3,
                                    axis=1))
    y2 = sp.dst(x.astype(np.float64), type=2, axis=1) / 2
    ref = sp.dst((2.0 / n) * H[None, :, None] * y2, type=3, axis=1) / 2
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    comp = np.asarray(nddst3(
        jnp.asarray(H).reshape(1, n, 1)
        * nddst2(jnp.asarray(x), h2, axis=1), h3, axis=1))
    assert np.abs(got - comp).max() < 2e-4 * np.abs(comp).max()


def test_dst_identity_and_custom_fallback():
    from ndrustfft_tpu import DstHandler, ndspectral_dst

    rng = np.random.default_rng(31)
    n = 64
    x = rng.standard_normal((2, n, 8)).astype(np.float32)
    h2 = DstHandler(n).normalization(Normalization.NONE)
    h3 = DstHandler(n).normalization(Normalization.scalar(2.0 / n))
    y = np.asarray(ndspectral_dst(jnp.asarray(x), jnp.ones(n), h2, h3,
                                  axis=1))
    assert np.abs(y - x).max() < 1e-4  # dst3(dst2(x)) * 2/n = x
    # custom norm falls back to the composition and stays correct
    hc = DstHandler(n).normalization(
        Normalization.custom(lambda v: 2.0 * v / n))
    yc = np.asarray(ndspectral_dst(jnp.asarray(x), jnp.ones(n), h2, hc,
                                   axis=1))
    assert np.abs(yc - x).max() < 1e-4


# ---- lane-varying multipliers: (rows,) + trailing dims (2-D Poisson) ----


def test_lanevar_multipliers_all_bases():
    import scipy.fft as sp

    from ndrustfft_tpu import (
        DctHandler, DstHandler, FftHandler, ndspectral_c2c, ndspectral_dct,
        ndspectral_dst,
    )

    n, L = 512, 16
    m = n // 2 + 1
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, n, L)).astype(np.float32)
    # r2c with (m, L) complex multiplier
    H = (rng.standard_normal((m, L))
         + 1j * rng.standard_normal((m, L))).astype(np.complex64)
    got = np.asarray(ndspectral_r2c(jnp.asarray(x), jnp.asarray(H),
                                    R2cFftHandler(n), axis=1))
    S = np.asarray(H, np.complex128)[None] \
        * np.fft.rfft(x.astype(np.float64), axis=1) / n
    S[:, 0, :] = S[:, 0, :].real
    S[:, -1, :] = S[:, -1, :].real
    ref = np.fft.irfft(S * n, n=n, axis=1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    # c2c with (n, L)
    xc = (rng.standard_normal((2, n, L))
          + 1j * rng.standard_normal((2, n, L))).astype(np.complex64)
    Hc = (rng.standard_normal((n, L))
          + 1j * rng.standard_normal((n, L))).astype(np.complex64)
    got = np.asarray(ndspectral_c2c(jnp.asarray(xc), jnp.asarray(Hc),
                                    FftHandler(n), axis=1))
    ref = np.fft.ifft(np.asarray(Hc, np.complex128)[None]
                      * np.fft.fft(xc.astype(np.complex128), axis=1),
                      axis=1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-4
    # dct and dst with (n, L)
    Hd = rng.standard_normal((n, L)).astype(np.float32)
    h2 = DctHandler(n).normalization(Normalization.NONE)
    h3 = DctHandler(n).normalization(Normalization.scalar(2.0 / n))
    got = np.asarray(ndspectral_dct(jnp.asarray(x), jnp.asarray(Hd), h2,
                                    h3, axis=1))
    y2 = sp.dct(x.astype(np.float64), type=2, axis=1) / 2
    ref = sp.dct((2.0 / n) * Hd[None] * y2, type=3, axis=1) / 2
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    s2 = DstHandler(n).normalization(Normalization.NONE)
    s3 = DstHandler(n).normalization(Normalization.scalar(2.0 / n))
    got = np.asarray(ndspectral_dst(jnp.asarray(x), jnp.asarray(Hd), s2,
                                    s3, axis=1))
    z2 = sp.dst(x.astype(np.float64), type=2, axis=1) / 2
    ref = sp.dst((2.0 / n) * Hd[None] * z2, type=3, axis=1) / 2
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
