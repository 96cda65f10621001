"""Multi-axis convenience API: fftn / ifftn / rfftn / irfftn / dctn.

The reference exposes only per-axis functions; multi-dim pipelines are
composed by the user (examples/fft2.rs, examples/rfft2.rs). This module
packages those canonical compositions — the numpy/scipy-style surface a
JAX user expects — on top of the same handlers/engine, with handler caching
per axis length. For mesh-sharded global arrays use
``ndrustfft_tpu.parallel`` instead (same compositions, device-local
transforms + all-to-all).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp

from .api import (
    _auto_handler, nddct1, nddct2, nddct3, nddct4, nddst1, nddst2, nddst3,
    nddst4, ndfft, ndfft_r2c, ndifft, ndifft_r2c,
)
from .handlers import DctHandler, DstHandler, FftHandler, R2cFftHandler

__all__ = ["fftn", "ifftn", "rfftn", "irfftn", "dctn", "idctn",
           "dstn", "idstn"]

_DCT = {1: nddct1, 2: nddct2, 3: nddct3, 4: nddct4}
_DST = {1: nddst1, 2: nddst2, 3: nddst3, 4: nddst4}


def _axes(x, axes):
    return list(range(x.ndim)) if axes is None else [a % x.ndim for a in axes]


def fftn(x, axes: Optional[Sequence[int]] = None):
    """C2C forward FFT over ``axes`` (all by default), unnormalized."""
    x = jnp.asarray(x)
    for a in _axes(x, axes):
        x = ndfft(x, _auto_handler(FftHandler, x.shape[a]), axis=a)
    return x


def ifftn(x, axes: Optional[Sequence[int]] = None):
    """C2C inverse FFT over ``axes``; Default normalization (1/n per axis)."""
    x = jnp.asarray(x)
    for a in _axes(x, axes):
        x = ndifft(x, _auto_handler(FftHandler, x.shape[a]), axis=a)
    return x


def rfftn(x, axes: Optional[Sequence[int]] = None):
    """Real n-D forward: R2C along the LAST of ``axes``, C2C along the rest
    (the canonical composition of examples/rfft2.rs, matching numpy.rfftn's
    axis convention)."""
    x = jnp.asarray(x)
    axes = _axes(x, axes)
    r2c_axis = axes[-1]
    x = ndfft_r2c(x, _auto_handler(R2cFftHandler, x.shape[r2c_axis]),
                  axis=r2c_axis)
    for a in axes[:-1]:
        x = ndfft(x, _auto_handler(FftHandler, x.shape[a]), axis=a)
    return x


def irfftn(x, n_last: Optional[int] = None,
           axes: Optional[Sequence[int]] = None):
    """Inverse of :func:`rfftn`. ``n_last`` is the real length of the final
    axis (defaults to the even reconstruction 2*(m-1), like numpy)."""
    x = jnp.asarray(x)
    axes = _axes(x, axes)
    c2r_axis = axes[-1]
    for a in axes[:-1]:
        x = ndifft(x, _auto_handler(FftHandler, x.shape[a]), axis=a)
    m = x.shape[c2r_axis]
    n = n_last if n_last is not None else 2 * (m - 1)
    return ndifft_r2c(x, _auto_handler(R2cFftHandler, n), axis=c2r_axis)


def dctn(x, dct_type: int = 2, axes: Optional[Sequence[int]] = None):
    """Real n-D DCT of the given type over ``axes`` (scipy.fft.dctn analog,
    Default == scipy's unnormalized convention)."""
    x = jnp.asarray(x)
    fn = _DCT[dct_type]
    for a in _axes(x, axes):
        x = fn(x, _auto_handler(DctHandler, x.shape[a]), axis=a)
    return x


def idctn(x, dct_type: int = 2, axes: Optional[Sequence[int]] = None):
    """Inverse n-D DCT: the type-2/3 (and 1/1, 4/4 self-inverse) duality
    with the 1/(2n) scale per axis — the way the reference's users express
    IDCT (SURVEY.md §3.5)."""
    inv_type = {1: 1, 2: 3, 3: 2, 4: 4}[dct_type]
    x = jnp.asarray(x)
    fn = _DCT[inv_type]
    for a in _axes(x, axes):
        n = x.shape[a]
        x = fn(x, _auto_handler(DctHandler, n), axis=a)
        if inv_type == 1:
            x = x / (2.0 * (n - 1))
        else:
            x = x / (2.0 * n)
    return x


def dstn(x, dst_type: int = 2, axes: Optional[Sequence[int]] = None):
    """Real n-D DST of the given type over ``axes`` (scipy.fft.dstn analog,
    Default == scipy's unnormalized convention). Beyond-parity: the
    reference has no DST family (ops/dst.py)."""
    x = jnp.asarray(x)
    fn = _DST[dst_type]
    for a in _axes(x, axes):
        x = fn(x, _auto_handler(DstHandler, x.shape[a]), axis=a)
    return x


def idstn(x, dst_type: int = 2, axes: Optional[Sequence[int]] = None):
    """Inverse n-D DST: type-2/3 duality (1 and 4 self-inverse) with the
    1/(2n) scale per axis — 1/(2(n+1)) for DST-I, whose eigen-length is
    n+1 (scipy: dst(dst(x, 1), 1) == 2*(n+1)*x)."""
    inv_type = {1: 1, 2: 3, 3: 2, 4: 4}[dst_type]
    x = jnp.asarray(x)
    fn = _DST[inv_type]
    for a in _axes(x, axes):
        n = x.shape[a]
        x = fn(x, _auto_handler(DstHandler, n), axis=a)
        if inv_type == 1:
            x = x / (2.0 * (n + 1))
        else:
            x = x / (2.0 * n)
    return x
