"""Autodiff through the public transforms, against closed-form adjoints.

Every transform family is linear, so its reverse-mode gradient is the
adjoint (conjugate transpose) of its matrix and its forward-mode tangent is
the transform of the tangent. These tests build each family's matrix from
the numpy/scipy float64 reference (the transform applied to the identity)
and pin ``jax.grad`` / ``jax.jvp`` / ``jax.linearize`` of the public
functions to it — including a nonlinear custom normalization (whose
derivative is taken at the primal), the composition cases (jit+grad,
forward-over-reverse) and the pencil path. The reference has no autodiff
at all; grads are an extension of this build.
"""

import numpy as np
import pytest
import scipy.fft as sf

import jax
import jax.numpy as jnp
from ndrustfft_tpu import (
    DctHandler, DstHandler, FftHandler, Normalization, R2cFftHandler,
    nddct1, nddct2, nddct3, nddct4, nddst2, ndfft, ndfft_r2c, ndifft,
    ndifft_r2c,
)

_N = 256
_REL = 5e-5


def _x(shape, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).standard_normal(shape), jnp.float32)


def _mat(ref_fn, n):
    """The (out, n) matrix of a reference transform along axis 0."""
    return ref_fn(np.eye(n))


def _apply(m, v):
    """``m`` applied along axis 1 of a (B, n, L) array."""
    return np.einsum("kn,bnl->bkl", m, v)


def _close(got, want):
    got = np.asarray(got)
    assert np.all(np.isfinite(got))
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert rel < _REL, rel


def _pin_sq_grad(fn, m, x):
    """grad of sum|fn(x)|^2 for real x and fn = m along axis 1 is
    2 Re(m^H m x)."""
    g = jax.grad(lambda v: jnp.sum(jnp.abs(fn(v)) ** 2))(x)
    xv = np.asarray(x, np.float64)
    _close(g, 2.0 * np.real(_apply(m.conj().T, _apply(m, xv))))


def test_grad_c2c_forward_kernel_route():
    h = FftHandler(_N)
    # Parseval: d/dx sum|F x|^2 = 2 n x for real x
    x = _x((4, _N, _N))
    g = jax.grad(lambda v: jnp.sum(jnp.abs(
        ndfft(jnp.asarray(v, jnp.complex64), h, axis=1)) ** 2))(x)
    _close(g, 2.0 * _N * np.asarray(x, np.float64))


def test_grad_c2c_inverse_default_norm():
    h = FftHandler(_N)
    x = _x((4, _N, _N))
    g = jax.grad(lambda v: jnp.sum(jnp.abs(
        ndifft(jnp.asarray(v, jnp.complex64), h, axis=1)) ** 2))(x)
    _close(g, 2.0 / _N * np.asarray(x, np.float64))


def test_grad_r2c_and_c2r():
    hr = R2cFftHandler(_N)
    _pin_sq_grad(lambda v: ndfft_r2c(v, hr, axis=1),
                 _mat(lambda e: np.fft.rfft(e, axis=0), _N), _x((4, _N, _N)))
    m = _N // 2 + 1
    _pin_sq_grad(lambda v: ndifft_r2c(jnp.asarray(v, jnp.complex64), hr,
                                      axis=1),
                 _mat(lambda e: np.fft.irfft(e, n=_N, axis=0), m),
                 _x((2, m, _N)))


@pytest.mark.parametrize("dct_type,fn", [(1, nddct1), (2, nddct2),
                                         (3, nddct3), (4, nddct4)])
def test_grad_dct_family(dct_type, fn):
    n = 257 if dct_type == 1 else _N  # odd n for DCT-I
    h = DctHandler(n)
    _pin_sq_grad(lambda v: fn(v, h, axis=1),
                 _mat(lambda e: sf.dct(e, type=dct_type, axis=0), n),
                 _x((2, n, _N)))


def test_grad_dst_rides_dct_conjugations():
    h = DstHandler(_N)
    _pin_sq_grad(lambda v: nddst2(v, h, axis=1),
                 _mat(lambda e: sf.dst(e, type=2, axis=0), _N),
                 _x((2, _N, _N)))


def _cube_policy_grad(x):
    """Closed-form grad of sum|g(u)|^2 = sum|u|^4 for u = n * ifft(x)
    (the unnormalized inverse) and g(u) = u|u|: 4 Re(A^T (|u|^2 conj u))
    with A = n * ifft, a symmetric matrix."""
    a = _mat(lambda e: np.fft.ifft(e, axis=0) * _N, _N)
    u = _apply(a, np.asarray(x, np.float64))
    return 4.0 * np.real(_apply(a.T, np.abs(u) ** 2 * np.conj(u)))


def test_grad_custom_nonlinear_policy_saved_primal():
    # a NONLINEAR custom callable: its derivative must be taken at the
    # primal
    h = FftHandler(_N).normalization(
        Normalization.custom(lambda v: v * jnp.abs(v)))
    x = _x((4, _N, _N)) / _N
    g = jax.grad(lambda v: jnp.sum(jnp.abs(
        ndifft(jnp.asarray(v, jnp.complex64), h, axis=1)) ** 2))(x)
    _close(g, _cube_policy_grad(x))


def test_grad_under_jit_and_vmap_compose():
    h = FftHandler(_N)
    x = _x((4, _N, _N))

    def loss(v):
        return jnp.sum(jnp.abs(
            ndfft(jnp.asarray(v, jnp.complex64), h, axis=1)) ** 2)

    g_jit = np.asarray(jax.jit(jax.grad(loss))(x))
    g_eager = np.asarray(jax.grad(loss)(x))
    np.testing.assert_allclose(g_jit, g_eager, rtol=5e-4,
                               atol=1e-4 * np.abs(g_eager).max())
    _close(g_jit, 2.0 * _N * np.asarray(x, np.float64))
    out = jax.vmap(lambda v: ndfft(v, h, axis=0))(
        jnp.asarray(np.zeros((3, _N, 8)), jnp.complex64))
    assert out.shape == (3, _N, 8)


def test_grad_spectral_pipeline_bluestein():
    # prime n on a mid axis: the chirp-z route; Parseval holds for any n
    n = 257
    h = FftHandler(n)
    x = _x((2, n, _N), seed=3)
    g = jax.grad(lambda v: jnp.sum(jnp.abs(
        ndfft(jnp.asarray(v, jnp.complex64), h, axis=1)) ** 2))(x)
    _close(g, 2.0 * n * np.asarray(x, np.float64))


def _pencil_mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]), ("d",))


def test_grad_through_pencil_transform():
    # grad of a sharded 2-D spectral loss on an 8-device mesh: Parseval
    # over both axes, sum|F2 x|^2 = N^2 sum|x|^2, whose JAX gradient for a
    # complex input is 2 N^2 conj(x)
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from ndrustfft_tpu.parallel import fftn_pencil

    mesh = _pencil_mesh()
    v = jnp.asarray(_x((_N, _N)) + 1j * _x((_N, _N), 1), jnp.complex64)

    def loss(x):
        out, _ = fftn_pencil(x, mesh, P("d", None))
        return jnp.sum(jnp.abs(out) ** 2)

    x = jax.device_put(v, NamedSharding(mesh, P("d", None)))
    g = jax.grad(loss)(x)
    _close(g, 2.0 * _N * _N * np.conj(np.asarray(v, np.complex128)))


def test_no_wrapper_on_plain_cpu_forward_mode_intact():
    # forward mode through a linear map: jvp tangent == map(tangent)
    h = FftHandler(64)
    x = jnp.asarray(np.ones((4, 64)), jnp.complex64)
    y, t = jax.jvp(lambda v: ndfft(v, h, axis=1), (x,), (x,))
    np.testing.assert_allclose(np.asarray(y), np.asarray(t), rtol=1e-6)


# --------------------------------------------------------------------------
# Forward-mode AD: the tangent of a linear map is the map of the tangent
# --------------------------------------------------------------------------


def test_jvp_every_family_kernel_route():
    from ndrustfft_tpu import nddst1, nddst3, nddst4

    h = FftHandler(_N)
    hr = R2cFftHandler(_N)
    hd = DctHandler(_N)
    xc = jnp.asarray(_x((2, _N, _N)), jnp.complex64)
    xr = _x((2, _N, _N), 1)
    tc = jnp.asarray(_x((2, _N, _N), 2) + 1j * _x((2, _N, _N), 6),
                     jnp.complex64)
    tr = _x((2, _N, _N), 3)
    tc64 = np.asarray(tc, np.complex128)
    tr64 = np.asarray(tr, np.float64)

    def tangent(fn, x, t):
        return jax.jvp(fn, (x,), (t,))[1]

    _close(tangent(lambda v: ndfft(v, h, axis=1), xc, tc),
           np.fft.fft(tc64, axis=1))
    _close(tangent(lambda v: ndifft(v, h, axis=1), xc, tc),
           np.fft.ifft(tc64, axis=1))
    _close(tangent(lambda v: ndfft_r2c(v, hr, axis=1), xr, tr),
           np.fft.rfft(tr64, axis=1))
    xs = jnp.asarray(_x((2, _N // 2 + 1, _N), 4), jnp.complex64)
    ts = jnp.asarray(_x((2, _N // 2 + 1, _N), 5), jnp.complex64)
    _close(tangent(lambda v: ndifft_r2c(v, hr, axis=1), xs, ts),
           np.fft.irfft(np.asarray(ts, np.complex128), n=_N, axis=1))
    for fn, ref, t in ((nddct1, sf.dct, 1), (nddct2, sf.dct, 2),
                       (nddct3, sf.dct, 3), (nddct4, sf.dct, 4),
                       (nddst1, sf.dst, 1), (nddst3, sf.dst, 3),
                       (nddst4, sf.dst, 4)):
        _close(tangent(lambda v, _f=fn: _f(v, axis=1), xr, tr),
               ref(tr64, type=t, axis=1))
    # hd exercises the handler-carrying path too
    _close(tangent(lambda v: nddct2(v, hd, axis=1), xr, tr),
           sf.dct(tr64, type=2, axis=1))


def test_linearize_and_jit_jvp_compose():
    h = FftHandler(_N)
    x = jnp.asarray(_x((2, _N, _N)), jnp.complex64)
    t = jnp.asarray(_x((2, _N, _N), 2), jnp.complex64)
    want = np.fft.fft(np.asarray(t, np.complex128), axis=1)
    _, lin = jax.linearize(lambda v: ndfft(v, h, axis=1), x)
    _close(lin(t), want)
    # jit(jvp) keeps working
    tk = jax.jit(lambda a, b: jax.jvp(
        lambda v: ndfft(v, h, axis=1), (a,), (b,))[1])(x, t)
    _close(tk, want)


def test_jvp_custom_nonlinear_policy():
    # nonlinear custom policy g(u) = u|u| after the unnormalized inverse:
    # the tangent is du |u| + u Re(conj(u) du) / |u| at the primal
    h = FftHandler(_N).normalization(
        Normalization.custom(lambda v: v * jnp.abs(v)))
    x = jnp.asarray(_x((2, _N, _N)), jnp.complex64)
    t = jnp.asarray(_x((2, _N, _N), 2), jnp.complex64)
    _, got = jax.jvp(lambda v: ndifft(v, h, axis=1), (x,), (t,))
    u = np.fft.ifft(np.asarray(x, np.complex128), axis=1) * _N
    du = np.fft.ifft(np.asarray(t, np.complex128), axis=1) * _N
    au = np.abs(u)
    _close(got, du * au + u * np.real(np.conj(u) * du) / au)


def test_hvp_forward_over_reverse():
    # the Hessian of sum|F x|^2 is 2 n I: hvp(t) = 2 n t
    h = FftHandler(_N)
    x = _x((2, _N, _N))
    t = _x((2, _N, _N), 2)

    def loss(v):
        return jnp.sum(jnp.abs(
            ndfft(jnp.asarray(v, jnp.complex64), h, axis=1)) ** 2)

    hv = jax.jvp(jax.grad(loss), (x,), (t,))[1]
    _close(hv, 2.0 * _N * np.asarray(t, np.float64))


def test_jvp_through_pencil_transform():
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from ndrustfft_tpu.parallel import fftn_pencil

    mesh = _pencil_mesh()
    v = jnp.asarray(_x((_N, _N)), jnp.complex64)
    t = jnp.asarray(_x((_N, _N), 2), jnp.complex64)

    def fn(x):
        out, _ = fftn_pencil(x, mesh, P("d", None))
        return out

    xs = jax.device_put(v, NamedSharding(mesh, P("d", None)))
    ts = jax.device_put(t, NamedSharding(mesh, P("d", None)))
    _, got = jax.jvp(fn, (xs,), (ts,))
    _close(got, np.fft.fft2(np.asarray(t, np.complex128)))
