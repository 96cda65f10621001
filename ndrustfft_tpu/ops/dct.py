"""DCT types 1-4 lowered to (real) FFTs — the rustdct capability rebuilt.

The reference delegates DCT math to rustdct (SURVEY.md §2.2 N3). Here each
type is lowered to the engine's FFT schedules with pre/post twiddles, in the
rustdct convention (== scipy's unnormalized dct / 2 — the reference's Default
normalization multiplies by 2 to produce scipy values, src/lib.rs:736-741):

  DCT-I   y[k] = (x0 + (-1)^k x_{n-1})/2 + sum_{t=1}^{n-2} x_t cos(pi t k/(n-1))
          == Re(FFT_{2n-2}(even-extension))[k] / 2
  DCT-II  y[k] = sum_t x_t cos(pi k (2t+1) / (2n))
          == Re( e^{-i pi k/(2n)} * FFT_n(even-odd permuted x)[k] )   (Makhoul)
  DCT-III y[k] = x0/2 + sum_{t>=1} x_t cos(pi t (2k+1) / (2n))
          == unperm( Re( FFT_n((c, c0/2) * e^{-i pi t/(2n)}) ) )  (transpose
          of the Makhoul DCT-II algorithm; n-point)
  DCT-IV  y[k] = sum_t x_t cos(pi (2k+1)(2t+1) / (4n))
          == Re( e^{-i pi (2k+1)/(4n)} * FFT_{2n}(x_t e^{-i pi t/(2n)}, pad)[k] )

All transforms operate batched along the LAST axis on real arrays.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..plan import _cis, get_c2c_plan, get_r2c_plan
from .engine import _cmul, _const, c2c, r2c, r2c_packed


@lru_cache(maxsize=512)
def _dct2_consts(n: int):
    return _cis(np.arange(n, dtype=np.int64), 2 * n, -1)  # e^{-i pi k/(2n)}


def _evenodd_perm(x):
    """Makhoul permutation [x0, x2, .., x_odd desc] via slice+flip (no
    gather): evens ascending then odds descending."""
    return jnp.concatenate([x[..., 0::2], x[..., 1::2][..., ::-1]], axis=-1)


def dct2(x, scale=None):
    """(..., n) real -> scale * DCT-II, rustdct convention.

    Makhoul: an n-point real FFT of the even/odd-permuted input, then a
    post twiddle; ``scale`` (the handler's scalar normalization) folds into
    the post twiddle (constant-folded by jit)."""
    n = x.shape[-1]
    s = 1.0 if scale is None else scale
    if n == 1:
        return x * jnp.asarray(s, x.dtype) if scale is not None else x
    w = _dct2_consts(n)
    m = n // 2 + 1
    v = _evenodd_perm(x)
    vr, vi = r2c(v, get_r2c_plan(n))
    # Hermitian unfold V[k] = conj(V[n-k]) for k >= m via flip/concat
    # (fuses into neighbours, unlike a gather): tail indices n-1..m ==
    # flip(1..n-m)
    vr_full = jnp.concatenate([vr, vr[..., 1:n - m + 1][..., ::-1]], axis=-1)
    vi_full = jnp.concatenate([vi, -vi[..., 1:n - m + 1][..., ::-1]], axis=-1)
    wr, wi = _const((w[0] * s, w[1] * s), x.dtype)
    return vr_full * wr - vi_full * wi


@lru_cache(maxsize=512)
def _dct3_consts(n: int):
    # inverse-Makhoul: DCT-III is the transpose of the DCT-II algorithm:
    #   z[perm] = Re( FFT_n( (c with c0/2) * e^{-i pi t/(2n)} ) )
    return _cis(np.arange(n, dtype=np.int64), 2 * n, -1)  # e^{-i pi t/(2n)}


def _evenodd_unperm(u, n):
    """Scatter z[perm] = u without a gather: z[2t] = u[t] (t < ceil),
    z[2t+1] = flip(u[ceil:]) — interleave via stack+reshape (odd n pads one
    dummy slot that the final slice drops)."""
    ceil = (n + 1) // 2
    evens = u[..., :ceil]
    odds = u[..., ceil:][..., ::-1]
    if n % 2 == 1:
        odds = jnp.concatenate([odds, odds[..., :1]], axis=-1)  # dummy
    z = jnp.stack([evens, odds], axis=-1).reshape(u.shape[:-1] + (2 * ceil,))
    return z[..., :n]


def dct3(x, scale=None):
    """(..., n) real -> scale * DCT-III, rustdct convention (x0 halved
    internally).

    n-point complex FFT via the transpose of the Makhoul DCT-II algorithm
    (2-4x cheaper than the zero-padded 4n lowering); ``scale`` folds into
    the pre-twiddle constants."""
    n = x.shape[-1]
    s = 1.0 if scale is None else scale
    if n == 1:
        return (0.5 * s) * x
    pre = _dct3_consts(n)
    c = jnp.concatenate([x[..., :1] * 0.5, x[..., 1:]], axis=-1)
    prer, prei = _const((pre[0] * s, pre[1] * s), x.dtype)
    ur, ui = c * prer, c * prei
    zr, _ = c2c(ur, ui, get_c2c_plan(n, -1))
    return _evenodd_unperm(zr, n)


def dct1(x, scale=None):
    """(..., n) real -> scale * DCT-I, rustdct convention. Requires n >= 2.

    DCT-I == Re(FFT_{2n-2}(even extension))/2, but the (2n-2)-length
    extension is never materialized: the r2c pack trick only consumes the
    even/odd sample streams of the extension, and both are direct slice/
    flip/concat views of x (one n-length pass instead of a 2n-length
    round trip; verified identical to the concat form for all n).
    """
    n = x.shape[-1]
    if n < 2:
        raise ValueError(f"DCT-I requires length >= 2, got {n}")
    # ext = [x, x[n-2:0:-1]] (len 2n-2); its even/odd interleave streams:
    xe = jnp.concatenate(
        [x[..., 0::2], x[..., 2:n - 1:2][..., ::-1]], axis=-1)
    xo = jnp.concatenate(
        [x[..., 1::2], x[..., 1:n - 2 + (n % 2):2][..., ::-1]], axis=-1)
    sr, _ = r2c_packed(xe, xo, get_r2c_plan(2 * n - 2))  # m = n bins exactly
    return (0.5 if scale is None else 0.5 * scale) * sr


@lru_cache(maxsize=512)
def _dct4_consts(n: int):
    t = np.arange(n, dtype=np.int64)
    pre_a = _cis(t, 2 * n, -1)                       # e^{-i pi t/(2n)}
    w = _cis(2 * t, 2 * n, -1)                       # e^{-i pi t/n}
    pre_b = (pre_a[0] * w[0] - pre_a[1] * w[1],      # pre * w
             pre_a[0] * w[1] + pre_a[1] * w[0])
    ne, no = (n + 1) // 2, n // 2
    je = np.arange(ne, dtype=np.int64)
    jo = np.arange(no, dtype=np.int64)
    post_e = _cis(4 * je + 1, 4 * n, -1)             # post[2j]
    post_o = _cis(4 * jo + 3, 4 * n, -1)             # post[2j+1]
    return pre_a, pre_b, post_e, post_o


def dct4(x, scale=None):
    """(..., n) real -> scale * DCT-IV, rustdct convention.

    Round-1 lowering zero-padded to a 2n-point FFT, materializing 2n-length
    intermediates in HBM. The zero half is folded out via the first DIF
    stage of that FFT (u_hi = 0):

        F_{2n}(pad(u))[2j]   = FFT_n(u)[j]
        F_{2n}(pad(u))[2j+1] = FFT_n(u * e^{-i pi t/n})[j]

    so DCT-IV = two n-point FFTs of pre-modulated inputs, batched into ONE
    engine call, using only the first ceil(n/2) bins of each; all buffers
    stay n-length.
    """
    n = x.shape[-1]
    s = 1.0 if scale is None else scale
    if n == 1:
        # single-point DCT-IV: y[0] = x[0] * cos(pi/4)
        return x * jnp.asarray(np.cos(np.pi / 4) * s, x.dtype)
    pre_a, pre_b, post_e, post_o = _dct4_consts(n)
    post_e = (post_e[0] * s, post_e[1] * s)   # scale folds into the post
    post_o = (post_o[0] * s, post_o[1] * s)   # twiddle (constant-folded)
    ne, no = (n + 1) // 2, n // 2
    par, pai = _const(pre_a, x.dtype)
    pbr, pbi = _const(pre_b, x.dtype)
    # batch the two modulated copies along a new leading-of-lane dim
    ur = jnp.stack([x * par, x * pbr], axis=-2)      # (..., 2, n)
    ui = jnp.stack([x * pai, x * pbi], axis=-2)
    fr, fi = c2c(ur, ui, get_c2c_plan(n, -1))
    ar, ai = fr[..., 0, :ne], fi[..., 0, :ne]        # A[j] = F[2j]
    br, bi = fr[..., 1, :no], fi[..., 1, :no]        # B[j] = F[2j+1]
    per, pei = _const(post_e, x.dtype)
    por, poi = _const(post_o, x.dtype)
    ye = ar * per - ai * pei                         # Re(post_e * A)
    yo = br * por - bi * poi                         # Re(post_o * B)
    if no < ne:
        yo = jnp.concatenate([yo, yo[..., :1]], axis=-1)  # dummy slot
    y = jnp.stack([ye, yo], axis=-1).reshape(x.shape[:-1] + (2 * ne,))
    return y[..., :n]


DCT_FNS = {1: dct1, 2: dct2, 3: dct3, 4: dct4}
