"""DST types 1-4 lowered onto the DCT/FFT schedules — beyond-parity.

The reference (ndrustfft v0.5.0) exposes DCT 1-4 only; its DCT backend
rustdct also ships DST 1-4, and spectral PDE users need them for Dirichlet
boundary conditions (the DCT serves Neumann). This module adds the family
in the same rustdct convention (== scipy's unnormalized ``dst`` / 2, so the
Default normalization's x2 produces scipy values — exactly the DCT story,
src/lib.rs:736-741).

Lowering: types 2-4 are EXACT flip/sign conjugations of the same-type
DCT, so they ride the DCT lowerings for the cost of two fusable
elementwise passes:

  DST-II  (x)[k] = DCT-II ((-1)^t * x)[n-1-k]
  DST-III (x)[k] = (-1)^k * DCT-III(flip(x))[k]   (incl. the x_{n-1}/2 edge)
  DST-IV  (x)[k] = (-1)^k * DCT-IV (flip(x))[k]

(each verified to 1e-12 against scipy.fft.dst for n = 1..129, see
tests/test_dst.py). DST-I has no flip twin; like DCT-I's even extension
(dct.py:134) it is the imaginary part of the FFT of the odd extension
[0, x, 0, -flip(x)] (length 2n+2), and the extension is never
materialized — the r2c pack trick consumes its even/odd sample streams,
which are slice/flip/concat views of x:

  DST-I   y[k] = sum_t x_t sin(pi (t+1)(k+1)/(n+1))
          == -Im(FFT_{2n+2}(odd-extension))[k+1] / 2

All transforms operate batched along the LAST axis on real arrays.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..plan import get_r2c_plan
from .dct import dct2, dct3, dct4
from .engine import r2c_packed


@lru_cache(maxsize=512)
def alt_signs(n: int):
    """(+1, -1, +1, ...) of length n (float64; cast at use site)."""
    return np.where(np.arange(n) % 2, -1.0, 1.0)


def _alt(x):
    return jnp.asarray(alt_signs(x.shape[-1]), x.dtype)


def dst1(x, scale=None):
    """(..., n) real -> scale * DST-I, rustdct convention.

    The odd extension's even/odd interleave streams (length n+1 each) feed
    the half-size pack FFT directly; output = the n interior imaginary
    bins. One n-length pass, no 2n+2 intermediate in HBM.
    """
    n = x.shape[-1]
    z = jnp.zeros_like(x[..., :1])
    xe_, xo_ = x[..., 1::2], x[..., 0::2]
    if n % 2 == 0:
        xe = jnp.concatenate([z, xe_, -xe_[..., ::-1]], axis=-1)
        xo = jnp.concatenate([xo_, z, -xo_[..., ::-1]], axis=-1)
    else:
        xe = jnp.concatenate([z, xe_, z, -xe_[..., ::-1]], axis=-1)
        xo = jnp.concatenate([xo_, -xo_[..., ::-1]], axis=-1)
    _, si = r2c_packed(xe, xo, get_r2c_plan(2 * n + 2))  # m = n + 2 bins
    s = -0.5 if scale is None else -0.5 * scale
    return s * si[..., 1:n + 1]


def dst2(x, scale=None):
    """(..., n) real -> scale * DST-II == flip(DCT-II((-1)^t x))."""
    return dct2(x * _alt(x), scale)[..., ::-1]


def dst3(x, scale=None):
    """(..., n) real -> scale * DST-III == (-1)^k DCT-III(flip(x))."""
    return dct3(x[..., ::-1], scale) * _alt(x)


def dst4(x, scale=None):
    """(..., n) real -> scale * DST-IV == (-1)^k DCT-IV(flip(x))."""
    return dct4(x[..., ::-1], scale) * _alt(x)


DST_FNS = {1: dst1, 2: dst2, 3: dst3, 4: dst4}
