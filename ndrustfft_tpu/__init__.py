"""ndrustfft_tpu — n-dimensional FFT / real-FFT / DCT framework in JAX.

A JAX/XLA implementation of the capabilities of
`ndrustfft <https://github.com/preiter93/ndrustfft>`_: axis-wise C2C FFT,
R2C/C2R FFT and DCT types 1-4 over n-D arrays with a plan-caching handler
API and scipy-style normalization. Lanes are batched instead of iterated;
base DFTs are dense matmuls; non-minor axes use fused/tiled transposes
instead of per-lane copies; multi-device scaling uses shard_map slab/pencil
decompositions with all-to-all between devices (see
``ndrustfft_tpu.parallel``).

Public surface (parity with the reference's 16 functions + 3 handlers +
Normalization enum, src/lib.rs:83-85, 115-124):

    from ndrustfft_tpu import (
        ndfft, ndifft, ndfft_r2c, ndifft_r2c, nddct1, nddct2, nddct3, nddct4,
        FftHandler, R2cFftHandler, DctHandler, Normalization,
    )

    h = FftHandler(1024).normalization(Normalization.DEFAULT)
    vhat = ndfft(v, h, axis=0)          # returns the output (functional)
    v2 = ndifft(vhat, h, axis=0)

Scalar/complex vocabulary (the reference re-exports ``Complex``, ``Zero``,
``FftNum`` from rustfft, src/lib.rs:83-85, so user code needs one import;
the dtype mapping here is ``Complex<f32>`` -> ``complex64``, ``Complex<f64>``
-> ``complex128``, ``T: FftNum`` -> ``float32 | float64``):

    >>> import ndrustfft_tpu as nd
    >>> nd.complex_dtype(nd.float32) == nd.complex64
    True
    >>> nd.real_dtype(nd.complex128) == nd.float64
    True
"""

from .api import (  # noqa: F401
    nddct1, nddct1_par, nddct2, nddct2_par, nddct3, nddct3_par, nddct4,
    nddct4_par, nddst1, nddst1_par, nddst2, nddst2_par, nddst3, nddst3_par,
    nddst4, nddst4_par, ndfft, ndfft_par, ndfft_r2c, ndfft_r2c_par, ndifft,
    ndifft_par, ndifft_r2c, ndifft_r2c_par, ndspectral_c2c,
    ndspectral_dct, ndspectral_dst, ndspectral_r2c,
)
from .config import config  # noqa: F401
from .ops import df64  # noqa: F401  — jittable double-float tier
#   (df64.split64 / df64.c2c_dd / df64.join64: an f32-pair representation
#    of f64 values, ~1e-13 accurate)
from .handlers import (  # noqa: F401
    DctHandler, DstHandler, FftHandler, R2cFftHandler,
)
from .ndapi import (  # noqa: F401
    dctn, dstn, fftn, idctn, idstn, ifftn, irfftn, rfftn,
)
from .normalization import Normalization  # noqa: F401

# Scalar/complex vocabulary re-exports (reference src/lib.rs:83-85): one
# import serves user code, like the reference's `Complex`, `Zero`, `FftNum`.
import jax.numpy as _jnp  # noqa: E402

float32 = _jnp.float32
float64 = _jnp.float64
complex64 = _jnp.complex64
complex128 = _jnp.complex128


def complex_dtype(real):
    """Complex dtype paired with a real dtype (f32 -> c64, f64 -> c128)."""
    import jax.numpy as jnp

    return jnp.complex128 if jnp.dtype(real) == jnp.float64 else jnp.complex64


def real_dtype(cplx):
    """Real dtype paired with a (possibly complex) dtype (c128 -> f64)."""
    import jax.numpy as jnp

    d = jnp.dtype(cplx)
    return jnp.finfo(d).dtype if jnp.issubdtype(d, jnp.complexfloating) else d


def __getattr__(name):
    # lazy re-exports: `ndrustfft_tpu.parallel` / `ndrustfft_tpu.runtime`
    # resolve without importing the multi-chip machinery at package import
    if name == "parallel":
        from . import parallel

        return parallel
    if name == "runtime":
        from .parallel import runtime

        return runtime
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "1.0.0"

__all__ = [
    "ndfft", "ndifft", "ndfft_par", "ndifft_par",
    "ndfft_r2c", "ndifft_r2c", "ndfft_r2c_par", "ndifft_r2c_par",
    "ndspectral_r2c", "ndspectral_dct", "ndspectral_c2c",
    "ndspectral_dst",
    "nddct1", "nddct2", "nddct3", "nddct4",
    "nddct1_par", "nddct2_par", "nddct3_par", "nddct4_par",
    "nddst1", "nddst2", "nddst3", "nddst4",
    "nddst1_par", "nddst2_par", "nddst3_par", "nddst4_par",
    "FftHandler", "R2cFftHandler", "DctHandler", "DstHandler",
    "Normalization",
    "fftn", "ifftn", "rfftn", "irfftn", "dctn", "idctn", "dstn", "idstn",
    "config", "df64",
    "float32", "float64", "complex64", "complex128",
    "complex_dtype", "real_dtype",
]
