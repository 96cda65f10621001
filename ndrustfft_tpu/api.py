"""Public functional API — all 16 entry points of the reference.

Parity surface (reference src/lib.rs:350-844): ``ndfft``, ``ndifft``,
``ndfft_r2c``, ``ndifft_r2c``, ``nddct1``..``nddct4`` and their ``_par``
twins. JAX is functional, so instead of writing into ``&mut output`` each
function RETURNS the output array; shapes/axis semantics and normalization
behavior are otherwise identical (see normalization.py for the pinned rules).

The reference's serial/parallel split (rayon ``par_for_each`` over lanes,
src/lib.rs:169-238) does not exist here: lanes are always batched into the
engine's matmuls. The ``_par`` names are kept so reference code ports 1:1,
and they additionally route mesh-sharded eager inputs through the
multi-device pencil path (see ``_make_par`` below and
``ndrustfft_tpu.parallel``). Inside a user ``jax.jit`` — where sharding is
invisible to tracing — they lower through
``jax.experimental.custom_partitioning`` so the SPMD partitioner itself
performs the pencil axis rotation (parallel/spmd.py;
``config.par_under_jit`` selects the legacy serial behavior).

Axis/layout generality: the reference's three-way dispatch (fast minor-axis
path / swap+copy / per-lane contiguity matrix, src/lib.rs:100-167) collapses
to a single ``moveaxis`` here — XLA fuses it or lowers it to a tiled
transpose.

Error parity: size mismatches raise ``ValueError("Size mismatch in fft, got
{got} expected {expected}")`` mirroring the reference's assert messages
(src/lib.rs:340-347, 743-750).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

from .handlers import DctHandler, DstHandler, FftHandler, R2cFftHandler
from .ops import dct as _dct
from .ops import dst as _dst
from .ops import engine as _engine
from .plan import get_c2c_plan, get_r2c_plan

__all__ = [
    "ndfft", "ndifft", "ndfft_par", "ndifft_par",
    "ndfft_r2c", "ndifft_r2c", "ndfft_r2c_par", "ndifft_r2c_par",
    "nddct1", "nddct2", "nddct3", "nddct4",
    "nddct1_par", "nddct2_par", "nddct3_par", "nddct4_par",
    "nddst1", "nddst2", "nddst3", "nddst4",
    "nddst1_par", "nddst2_par", "nddst3_par", "nddst4_par",
]


def _real_dtype(dtype):
    return jnp.finfo(dtype).dtype if jnp.issubdtype(dtype, jnp.complexfloating) else dtype


def _complex_dtype(dtype):
    return jnp.complex128 if jnp.dtype(dtype) == jnp.float64 else jnp.complex64


def _check_size(got: int, expected: int, what: str = "fft"):
    if got != expected:
        raise ValueError(f"Size mismatch in {what}, got {got} expected {expected}")


@lru_cache(maxsize=4096)
def _auto_handler(cls, n):
    return cls(n)


def _norm_axis(axis: int, ndim: int) -> int:
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of bounds for {ndim}-d array")
    return axis % ndim


# --------------------------------------------------------------------------
# Core implementations (traceable; transform axis moved to last)
# --------------------------------------------------------------------------


def _plan_log(kind, n, axis, path):
    """Opt-in dispatch observability (config.debug_plan_log): one stderr
    line per TRACED dispatch — the impls run once per compiled (kind,
    handler, axis, shape, dtype) cache entry, so this fires exactly when a
    new execution path is chosen, not per call (SURVEY.md §5: optional
    debug-level plan logging only)."""
    from .config import config as _cfg

    if _cfg.debug_plan_log:
        import sys

        print(f"[ndrustfft_tpu] {kind} n={n} axis={axis} -> {path}",
              file=sys.stderr)


def _moved(path, axis, ndim):
    """``path`` tagged with the moveaxis pair a non-minor axis costs."""
    return path + ("" if axis == ndim - 1 else "+moveaxis")


def _c2c_norm_scale(handler, sign):
    """Fusable scalar for the transform's normalization, or None.

    Forward C2C applies NO normalization regardless of policy (reference
    src/lib.rs:313-318); the inverse applies it after (src/lib.rs:321-331).
    Default (1/n) and scalar policies are linear scalings, so they ride the
    engine's ``scale`` and XLA fuses them into the last stage — the
    reference applies its 1/n inside the lane pass the same way
    (src/lib.rs:333-338). Custom callables cannot fuse.
    """
    if sign != +1:
        return None
    norm = handler.norm
    if norm.kind == "default":
        return 1.0 / handler.n
    if norm.kind == "scalar":
        return norm.value
    return None


def _apply_custom(fn, y, axis):
    """Apply a user ``Normalization.custom`` callable along ``axis``.

    The callable's contract (normalization.py) receives the transform axis
    LAST; on a non-minor axis the moveaxis pair brackets it and XLA fuses an
    elementwise ``fn`` into the transposes. The transform itself runs
    unnormalized and the callable adds one elementwise pass, at the
    reference's application point (src/lib.rs:321-331).
    """
    if axis == y.ndim - 1:
        return fn(y)
    return jnp.moveaxis(fn(jnp.moveaxis(y, axis, -1)), -1, axis)


def _unnormalized(handler):
    """The handler's NONE-normalized twin (same plan cache entries): the
    core that custom policies wrap with _apply_custom."""
    from .normalization import Normalization

    return handler.normalization(Normalization.NONE)


def _dct_scale(norm):
    """The DCT/DST policy as a scalar folded into the lowering, or None.

    Normalization applies BEFORE the transform (src/lib.rs:688-741); Default
    = x2 converts the rustdct convention to scipy's unnormalized dct."""
    if norm.kind == "default":
        return 2.0
    if norm.kind == "scalar":
        return norm.value
    return None


def _c2c_impl(x, handler, axis, sign):
    axis = _norm_axis(axis, x.ndim)
    _check_size(x.shape[axis], handler.n)
    if sign == +1 and handler.norm.kind == "custom":
        # custom policy: the callable runs AFTER the unnormalized inverse
        # (src/lib.rs:321-331)
        y = _c2c_impl(x, _unnormalized(handler), axis, sign)
        return _apply_custom(handler.norm.fn, y, axis)
    rdt = _real_dtype(x.dtype)
    plan = get_c2c_plan(handler.n, sign)
    from .config import config as _cfg

    name = "fft" if sign < 0 else "ifft"
    eng_scale = _c2c_norm_scale(handler, sign)
    if (axis == 0 and x.ndim >= 2 and plan.kind == "ct"
            and _cfg.axis0_strategy == "einsum"):
        # first-axis einsum contraction, no transpose
        xr = jnp.real(x).astype(rdt)
        xi = jnp.imag(x).astype(rdt)
        _plan_log(name, handler.n, axis, "axis0-einsum")
        yr, yi = _engine.c2c_axis0(xr, xi, plan, eng_scale)
        return jax.lax.complex(yr, yi)
    # moveaxis + the lane-last engine: XLA fuses the transposes into the
    # stage matmuls; the reference's "slow axis" (src/lib.rs:11-12) pays no
    # per-lane copies here
    xm = jnp.moveaxis(x, axis, -1)
    xr = jnp.real(xm).astype(rdt)
    xi = jnp.imag(xm).astype(rdt)
    _plan_log(name, handler.n, axis, _moved(
        f"engine-bluestein(M={plan.M})" if plan.kind == "bluestein"
        else "engine-lane-last", axis, x.ndim))
    yr, yi = _engine.c2c(xr, xi, plan, eng_scale)
    return jnp.moveaxis(jax.lax.complex(yr, yi), -1, axis)


def _r2c_impl(x, handler, axis):
    axis = _norm_axis(axis, x.ndim)
    _check_size(x.shape[axis], handler.n)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise TypeError("ndfft_r2c expects a real input array")
    plan = get_r2c_plan(handler.n)
    _plan_log("r2c", handler.n, axis, _moved(
        "engine-r2c" + ("-half" if plan.half else "-odd"), axis, x.ndim))
    xm = jnp.moveaxis(x, axis, -1)
    sr, si = _engine.r2c(xm, plan)
    return jnp.moveaxis(jax.lax.complex(sr, si), -1, axis)


def _c2r_impl(xhat, handler, axis):
    axis = _norm_axis(axis, xhat.ndim)
    n, m = handler.n, handler.m
    _check_size(xhat.shape[axis], m)
    if handler.norm.kind == "custom":
        # custom policy: the callable applies to the spectrum BEFORE the
        # inverse (src/lib.rs:506-523 order: normalize, zero DC/Nyquist
        # imag, invert)
        xh = _apply_custom(handler.norm.fn, xhat, axis)
        return _c2r_impl(xh, _unnormalized(handler), axis)
    rdt = _real_dtype(xhat.dtype)
    # Reference order (src/lib.rs:506-523): normalization FIRST on the
    # m-length spectrum (Default = 1/n over the FULL length n), THEN the
    # DC/Nyquist imag zeroing, then the inverse.
    norm = handler.norm
    scale = None
    if norm.kind == "default":
        scale = 1.0 / n
    elif norm.kind == "scalar":
        scale = norm.value
    _plan_log("c2r", n, axis, _moved("engine-c2r", axis, xhat.ndim))
    xm = jnp.moveaxis(xhat, axis, -1)
    sr = jnp.real(xm).astype(rdt)
    si = jnp.imag(xm).astype(rdt)
    y = _engine.c2r(sr, si, n, scale=scale, mask_dc_nyq=True)
    return jnp.moveaxis(y, -1, axis)


def _dct_impl(x, handler, axis, dct_type):
    axis = _norm_axis(axis, x.ndim)
    _check_size(x.shape[axis], handler.n, what="dct")
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise TypeError("nddct expects a real input array")
    if handler.norm.kind == "custom":
        # custom policy: the callable applies to the input BEFORE the
        # transform (src/lib.rs:688-741)
        x2 = _apply_custom(handler.norm.fn, x, axis)
        return _dct_impl(x2, _unnormalized(handler), axis, dct_type)
    _plan_log(f"dct{dct_type}", handler.n, axis,
              _moved("engine-dct", axis, x.ndim))
    xm = jnp.moveaxis(x, axis, -1)
    # the DCT is linear, so the policy scalar folds into the lowering's
    # constants
    y = _dct.DCT_FNS[dct_type](xm, _dct_scale(handler.norm))
    return jnp.moveaxis(y, -1, axis)


def _dst_impl(x, handler, axis, dst_type):
    """DST 1-4 along ``axis`` (ops/dst.py lowerings) — beyond-parity.

    Types 2-4 delegate to :func:`_dct_impl` through their exact flip/sign
    conjugations (DST-II = flip(DCT-II((-1)^t x)) etc., verified vs scipy),
    for the cost of two XLA-fused elementwise passes. DST-I runs the packed
    odd-extension lowering (no 2n+2 intermediate). Normalization semantics
    mirror the DCT: applied before the transform, Default = x2 -> scipy
    values (src/lib.rs:688-741).
    """
    axis = _norm_axis(axis, x.ndim)
    n = handler.n
    _check_size(x.shape[axis], n, what="dst")
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise TypeError("nddst expects a real input array")
    norm = handler.norm
    if norm.kind == "custom":
        # custom fn applies to the ORIGINAL input, before the conjugation
        # pre-pass (the DCT delegation below would apply it to the
        # sign-flipped input instead)
        x2 = _apply_custom(norm.fn, x, axis)
        return _dst_impl(x2, _unnormalized(handler), axis, dst_type)
    if dst_type == 1:
        _plan_log("dst1", n, axis, _moved("engine-dst1", axis, x.ndim))
        xm = jnp.moveaxis(x, axis, -1)
        return jnp.moveaxis(_dst.dst1(xm, _dct_scale(norm)), -1, axis)
    # types 2-4: conjugate the same-type DCT along the ORIGINAL axis
    shape = [1] * x.ndim
    shape[axis] = n
    alt = jnp.asarray(_dst.alt_signs(n), x.dtype).reshape(shape)
    dh = DctHandler(n).normalization(norm)
    if dst_type == 2:
        return jnp.flip(_dct_impl(x * alt, dh, axis, 2), axis)
    return _dct_impl(jnp.flip(x, axis), dh, axis, dst_type) * alt


def _c2c_dd_impl(x, h, axis, sign):
    """Double-float C2C over STACKED dd planes (the pencil dd step kinds).

    ``x`` is the (4, ...) f32 stack of :func:`ops.df64.split64` leaves
    (re_hi, re_lo, im_hi, im_lo); ``axis`` is in the STACKED frame (>= 1).
    The handler's normalization policy applies with the reference's C2C
    semantics (forward unnormalized, src/lib.rs:313-318; inverse scaled
    after, src/lib.rs:321-338): Default/scalar values fold in as an exact
    double-float multiply. A ``custom`` callable cannot run inside the dd
    plane representation (it would see split f32 leaves, not values) and
    raises. The planes are plain f32, so the all_to_all global transposes
    are LOSSLESS for the dd representation (f32 wire == the dd
    representation itself). The plane dim must never be split (it is
    unsharded and must not be a pipeline-chunk bystander — fftn_pencil_dd
    therefore runs unchunked)."""
    from .ops import df64

    if axis < 1:
        raise ValueError("dd transform axis 0 is the dd plane stack")
    if h.norm.kind == "custom":
        raise ValueError(
            "Normalization.custom is not supported on the double-float "
            "(dd) transform kinds: the callable would receive split f32 "
            "leaf planes instead of values. Use NONE/Default/scalar on "
            "the dd steps and apply the callable to the recombined "
            "(join64) result.")
    scale = _c2c_norm_scale(h, sign)
    outs = df64.c2c_dd(x[0], x[1], x[2], x[3], sign=sign, axis=axis - 1,
                       scale=scale)
    return jnp.stack(outs)


# --------------------------------------------------------------------------
# Eager-call jit cache: compiled once per (kind, handler, axis, shape, dtype)
# — the runtime analog of the reference's cached Arc<dyn Fft> plans.
# --------------------------------------------------------------------------

_IMPLS = {
    "fft": lambda x, h, a: _c2c_impl(x, h, a, -1),
    "ifft": lambda x, h, a: _c2c_impl(x, h, a, +1),
    "fft_dd": lambda x, h, a: _c2c_dd_impl(x, h, a, -1),
    "ifft_dd": lambda x, h, a: _c2c_dd_impl(x, h, a, +1),
    "r2c": _r2c_impl,
    "c2r": _c2r_impl,
    "dct1": lambda x, h, a: _dct_impl(x, h, a, 1),
    "dct2": lambda x, h, a: _dct_impl(x, h, a, 2),
    "dct3": lambda x, h, a: _dct_impl(x, h, a, 3),
    "dct4": lambda x, h, a: _dct_impl(x, h, a, 4),
    "dst1": lambda x, h, a: _dst_impl(x, h, a, 1),
    "dst2": lambda x, h, a: _dst_impl(x, h, a, 2),
    "dst3": lambda x, h, a: _dst_impl(x, h, a, 3),
    "dst4": lambda x, h, a: _dst_impl(x, h, a, 4),
}


def _config_key():
    # runtime config toggles must invalidate the eager jit cache — otherwise
    # flipping e.g. matmul_precision after a first call is a silent no-op
    from .config import config as _cfg

    return (_cfg.axis0_strategy, _cfg.matmul_precision, _cfg.max_base_radix,
            _cfg.debug_plan_log)


@lru_cache(maxsize=4096)
def _jitted(kind, handler, axis, cfg_key=None):
    impl = _IMPLS[kind]
    return jax.jit(lambda x: impl(x, handler, axis))


def _dispatch(kind, x, handler, axis):
    if isinstance(x, jax.core.Tracer):
        # inside a user jit: trace the impl into the caller's program
        return _IMPLS[kind](x, handler, axis)
    return _jitted(kind, handler, axis, _config_key())(x)


def _prep_complex(x):
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(_complex_dtype(x.dtype if jnp.issubdtype(x.dtype, jnp.floating)
                                    else jnp.float32))
    return x


def _prep_real(x):
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            return x  # validated (rejected) later with a clear error
        x = x.astype(jnp.float32)
    elif x.dtype in (jnp.bfloat16, jnp.float16):
        # sub-f32 inputs are promoted: twiddle tables below f32 would give
        # O(1e-2) transforms (dtype policy mirrors the reference's f32/f64)
        x = x.astype(jnp.float32)
    return x


# --------------------------------------------------------------------------
# Public functions
# --------------------------------------------------------------------------


def ndfft(x, handler: FftHandler | None = None, axis: int = -1):
    """n-D complex-to-complex forward FFT along ``axis`` (unnormalized).

    Functional form of the reference's ``ndfft(&input, &mut output, &handler,
    axis)`` (src/lib.rs:350-372): returns the transformed array.
    ``handler=None`` auto-plans for ``x.shape[axis]``.

    Example (reference doc-test, src/lib.rs:353-366)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import FftHandler, ndfft, ndifft
        >>> x = jnp.arange(8.0).astype(jnp.complex64)
        >>> h = FftHandler(8)
        >>> y = ndfft(x, h, axis=0)
        >>> bool(abs(y[0] - 28.0) < 1e-5)   # DC = sum(0..7)
        True
        >>> roundtrip = ndifft(y, h, axis=0)
        >>> bool(jnp.max(jnp.abs(roundtrip - x)) < 1e-5)
        True
    """
    x = _prep_complex(x)
    h = handler or _auto_handler(FftHandler, x.shape[_norm_axis(axis, x.ndim)])
    return _dispatch("fft", x, h, axis)


def ndifft(x, handler: FftHandler | None = None, axis: int = -1):
    """n-D C2C inverse FFT along ``axis``; normalization per handler policy
    applied after the transform (Default = 1/n; src/lib.rs:321-338).

    Example (normalization policies, reference examples/fft_norm.rs)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import FftHandler, Normalization, ndifft
        >>> x = jnp.ones(4, jnp.complex64)
        >>> none = FftHandler(4).normalization(Normalization.NONE)
        >>> bool(abs(ndifft(x, none, axis=0)[0] - 4.0) < 1e-5)  # no 1/n
        True
        >>> half = FftHandler(4).normalization(Normalization.custom(
        ...     lambda v: v * 0.5))
        >>> bool(abs(ndifft(x, half, axis=0)[0] - 2.0) < 1e-5)
        True
    """
    x = _prep_complex(x)
    h = handler or _auto_handler(FftHandler, x.shape[_norm_axis(axis, x.ndim)])
    return _dispatch("ifft", x, h, axis)


def ndfft_r2c(x, handler: R2cFftHandler | None = None, axis: int = -1):
    """Real-to-complex FFT along ``axis``: real length n -> m = n//2 + 1
    spectrum bins (src/lib.rs:543-564).

    Example (reference doc-test, src/lib.rs:545-558)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import R2cFftHandler, ndfft_r2c
        >>> v = jnp.ones((6, 4))
        >>> ndfft_r2c(v, R2cFftHandler(4), axis=1).shape
        (6, 3)
    """
    x = _prep_real(x)
    h = handler or _auto_handler(R2cFftHandler, x.shape[_norm_axis(axis, x.ndim)])
    return _dispatch("r2c", x, h, axis)


def ndifft_r2c(x, handler: R2cFftHandler | None = None, axis: int = -1,
               n: int | None = None):
    """Complex-to-real inverse FFT along ``axis``: m spectrum bins -> n reals.

    Reproduces the reference's exact semantics (src/lib.rs:506-523):
    normalization is applied to the spectrum BEFORE the inverse transform,
    then the DC bin's imaginary part is zeroed, and for even n the Nyquist
    bin's too — matching numpy's ``irfft`` on non-Hermitian input.

    Without a handler, ``n`` may be given explicitly; it defaults to the
    even-length reconstruction 2*(m-1), like numpy ``irfft``.

    Example (roundtrip, reference doc-test src/lib.rs:568-581)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import R2cFftHandler, ndfft_r2c, ndifft_r2c
        >>> x = jnp.asarray([0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
        >>> h = R2cFftHandler(6)
        >>> back = ndifft_r2c(ndfft_r2c(x, h, axis=0), h, axis=0)
        >>> bool(jnp.max(jnp.abs(back - x)) < 1e-5)
        True
    """
    x = _prep_complex(x)
    if handler is None:
        m = x.shape[_norm_axis(axis, x.ndim)]
        handler = _auto_handler(R2cFftHandler, n if n is not None else 2 * (m - 1))
    return _dispatch("c2r", x, handler, axis)


def _along(mult, ndim, axis):
    """A 1-D multiplier reshaped to broadcast along ``axis``; any other
    shape broadcasts as given (e.g. ``(m,) + trailing-dims``)."""
    if mult.ndim != 1:
        return mult
    shape = [1] * ndim
    shape[axis] = mult.shape[0]
    return mult.reshape(shape)


def _spectral_impl(kind, x, mult, h_fwd, h_inv, axis):
    """``inverse(mult * forward(x))`` along ``axis`` for one spectral
    ``kind`` — the whole step traces into one program, so XLA fuses the
    diagonal multiply into the neighbouring passes."""
    fwd, inv = _SPECTRAL[kind]
    axis = _norm_axis(axis, x.ndim)
    return _IMPLS[inv](_along(mult, x.ndim, axis)
                       * _IMPLS[fwd](x, h_fwd, axis), h_inv, axis)


_SPECTRAL = {"r2c": ("r2c", "c2r"), "c2c": ("fft", "ifft"),
             "dct": ("dct2", "dct3"), "dst": ("dst2", "dst3")}


@lru_cache(maxsize=1024)
def _spectral_jitted(kind, h_fwd, h_inv, axis, cfg_key=None):
    return jax.jit(lambda x, mult: _spectral_impl(kind, x, mult, h_fwd,
                                                  h_inv, axis))


def _spectral_dispatch(kind, x, multiplier, h_fwd, h_inv, axis):
    mult = jnp.asarray(multiplier)
    if isinstance(x, jax.core.Tracer) or isinstance(mult, jax.core.Tracer):
        return _spectral_impl(kind, x, mult, h_fwd, h_inv, axis)
    return _spectral_jitted(kind, h_fwd, h_inv, axis, _config_key())(x, mult)


def ndspectral_r2c(x, multiplier, handler: R2cFftHandler | None = None,
                   axis: int = -1):
    """Real spectral pipeline along ``axis``: exactly

        ``ndifft_r2c(multiplier * ndfft_r2c(x, handler, axis), handler, axis)``

    — forward R2C, diagonal frequency-domain multiply, normalized inverse
    C2R (the handler's normalization applies at the inverse, and the
    DC/Nyquist imaginary parts of the product spectrum are zeroed, both
    per the reference's inverse semantics, src/lib.rs:506-523) — compiled
    as ONE program, so the multiply fuses into the neighbouring passes
    instead of costing its own read and write of the spectrum.

    ``multiplier``: complex or real; shape ``(m,)`` (broadcast over all
    other axes) or any shape that broadcasts against the spectrum, e.g.
    ``(m,) + trailing-dims`` (the 2-D Poisson / full-field filter case).
    No reference analog (each transform is a separate call there) — an
    extension in the spirit of the reference's filter examples.

    Example (low-pass filter)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import R2cFftHandler, ndspectral_r2c
        >>> x = jnp.ones((4, 8))
        >>> keep = jnp.asarray([1.0, 1.0, 0.0, 0.0, 0.0])  # m = 5 bins
        >>> y = ndspectral_r2c(x, keep, R2cFftHandler(8), axis=1)
        >>> y.shape
        (4, 8)
        >>> bool(jnp.max(jnp.abs(y - x)) < 1e-5)   # DC passthrough
        True
    """
    x = _prep_real(x)
    h = handler or _auto_handler(R2cFftHandler,
                                 x.shape[_norm_axis(axis, x.ndim)])
    return _spectral_dispatch("r2c", x, multiplier, h, h, axis)


def ndspectral_c2c(x, multiplier, handler: FftHandler | None = None,
                   axis: int = -1):
    """Complex spectral pipeline along ``axis``: exactly

        ``ndifft(multiplier * ndfft(x, handler, axis), handler, axis)``

    (forward unnormalized, the handler's normalization applied at the
    inverse — the reference's C2C semantics, src/lib.rs:313-338), compiled
    as ONE program with the diagonal multiply fused into the neighbouring
    passes.

    ``multiplier``: complex or real, shape ``(n,)`` (broadcast) or any
    shape that broadcasts against the field, e.g. ``(n,) + trailing-dims``.
    No reference analog. See also :func:`ndspectral_r2c` (real fields) and
    :func:`ndspectral_dct` (cosine basis).

    Example (identity multiplier = roundtrip)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import FftHandler, ndspectral_c2c
        >>> x = jnp.exp(2j * jnp.pi * jnp.arange(8.0) / 8).reshape(1, 8)
        >>> y = ndspectral_c2c(x, jnp.ones(8), FftHandler(8), axis=1)
        >>> bool(jnp.max(jnp.abs(y - x)) < 1e-5)
        True
    """
    x = _prep_complex(x)
    h = handler or _auto_handler(FftHandler,
                                 x.shape[_norm_axis(axis, x.ndim)])
    return _spectral_dispatch("c2c", x, multiplier, h, h, axis)


def _real_basis_handlers(x, multiplier, handler, inv_handler, axis, cls,
                         what):
    h2 = handler or _auto_handler(cls, x.shape[_norm_axis(axis, x.ndim)])
    h3 = inv_handler or h2
    if h3.n != h2.n:
        raise ValueError(
            f"Size mismatch in {what}, got {h3.n} expected {h2.n}")
    if jnp.issubdtype(jnp.asarray(multiplier).dtype, jnp.complexfloating):
        raise TypeError(f"ndspectral_{what} expects a real multiplier (the "
                        f"{what.upper()} basis is real)")
    return h2, h3


def ndspectral_dct(x, multiplier, handler: DctHandler | None = None,
                   inv_handler: DctHandler | None = None, axis: int = -1):
    """Cosine-basis spectral pipeline along ``axis``: exactly

        ``nddct3(multiplier * nddct2(x, handler, axis), inv_handler, axis)``

    (``inv_handler`` defaults to ``handler``; each handler's normalization
    applies BEFORE its transform, the reference's DCT semantics,
    src/lib.rs:688-741) — the Neumann-boundary twin of
    :func:`ndspectral_r2c`: diagonal operators in the DCT basis (filters,
    second-derivative Poisson solves on non-periodic domains), compiled as
    ONE program. The real ``multiplier`` may be ``(n,)`` (broadcast) or any
    shape that broadcasts against the field, e.g. ``(n,) + trailing-dims``.
    No reference analog (separate calls there).

    Example (identity: DCT-III is DCT-II's inverse up to n/2 in the
    rustdct convention)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import DctHandler, Normalization
        >>> from ndrustfft_tpu import ndspectral_dct
        >>> x = jnp.arange(8.0).reshape(1, 8)
        >>> h2 = DctHandler(8).normalization(Normalization.NONE)
        >>> h3 = DctHandler(8).normalization(Normalization.scalar(2.0 / 8))
        >>> y = ndspectral_dct(x, jnp.ones(8), h2, h3, axis=1)
        >>> bool(jnp.max(jnp.abs(y - x)) < 1e-5)
        True
    """
    x = _prep_real(x)
    h2, h3 = _real_basis_handlers(x, multiplier, handler, inv_handler, axis,
                                  DctHandler, "dct")
    return _spectral_dispatch("dct", x, multiplier, h2, h3, axis)


def ndspectral_dst(x, multiplier, handler: DstHandler | None = None,
                   inv_handler: DstHandler | None = None, axis: int = -1):
    """Sine-basis spectral pipeline along ``axis``: exactly

        ``nddst3(multiplier * nddst2(x, handler, axis), inv_handler, axis)``

    (``inv_handler`` defaults to ``handler``) — the Dirichlet-boundary
    member of the family, compiled as ONE program like
    :func:`ndspectral_dct`.

    Example (identity: DST-III inverts DST-II up to n/2)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import DstHandler, Normalization
        >>> from ndrustfft_tpu import ndspectral_dst
        >>> x = jnp.arange(1.0, 9.0).reshape(1, 8)
        >>> h2 = DstHandler(8).normalization(Normalization.NONE)
        >>> h3 = DstHandler(8).normalization(Normalization.scalar(2.0 / 8))
        >>> y = ndspectral_dst(x, jnp.ones(8), h2, h3, axis=1)
        >>> bool(jnp.max(jnp.abs(y - x)) < 1e-5)
        True
    """
    x = _prep_real(x)
    h2, h3 = _real_basis_handlers(x, multiplier, handler, inv_handler, axis,
                                  DstHandler, "dst")
    _check_size(x.shape[_norm_axis(axis, x.ndim)], h2.n, what="dst")
    return _spectral_dispatch("dst", x, multiplier, h2, h3, axis)


def _make_dct(dct_type):
    def f(x, handler: DctHandler | None = None, axis: int = -1):
        x = _prep_real(x)
        h = handler or _auto_handler(DctHandler, x.shape[_norm_axis(axis, x.ndim)])
        return _dispatch(f"dct{dct_type}", x, h, axis)

    f.__name__ = f"nddct{dct_type}"
    f.__qualname__ = f.__name__
    f.__doc__ = (
        f"Real-to-real DCT-{'I' * dct_type if dct_type <= 3 else 'IV'} "
        f"(type {dct_type}) along ``axis`` (src/lib.rs:753-844). With the "
        f"Default normalization the output equals scipy.fft.dct(x, type="
        f"{dct_type}); with Normalization.NONE it equals the rustdct "
        f"convention (scipy / 2).\n\n"
        f"Example (scipy parity; reference doc-test src/lib.rs:754-769)::\n\n"
        f"    >>> import numpy as np, scipy.fft, jax.numpy as jnp\n"
        f"    >>> from ndrustfft_tpu import nddct{dct_type}\n"
        f"    >>> x = np.linspace(0.0, 1.0, 8)\n"
        f"    >>> got = nddct{dct_type}(jnp.asarray(x), axis=0)\n"
        f"    >>> want = scipy.fft.dct(x, type={dct_type})\n"
        f"    >>> bool(np.abs(np.asarray(got) - want).max() < 1e-4)\n"
        f"    True\n"
    )
    return f


nddct1 = _make_dct(1)
nddct2 = _make_dct(2)
nddct3 = _make_dct(3)
nddct4 = _make_dct(4)


def _make_dst(dst_type):
    def f(x, handler: DstHandler | None = None, axis: int = -1):
        x = _prep_real(x)
        h = handler or _auto_handler(DstHandler, x.shape[_norm_axis(axis, x.ndim)])
        return _dispatch(f"dst{dst_type}", x, h, axis)

    f.__name__ = f"nddst{dst_type}"
    f.__qualname__ = f.__name__
    f.__doc__ = (
        f"Real-to-real DST-{'I' * dst_type if dst_type <= 3 else 'IV'} "
        f"(type {dst_type}) along ``axis`` — beyond-parity extension (the "
        f"reference exposes DCT only; rustdct, its DCT backend, also ships "
        f"DST 1-4). With the Default normalization the output equals "
        f"scipy.fft.dst(x, type={dst_type}); with Normalization.NONE it "
        f"equals the rustdct convention (scipy / 2).\n\n"
        f"Example (scipy parity)::\n\n"
        f"    >>> import numpy as np, scipy.fft, jax.numpy as jnp\n"
        f"    >>> from ndrustfft_tpu import nddst{dst_type}\n"
        f"    >>> x = np.linspace(0.0, 1.0, 8)\n"
        f"    >>> got = nddst{dst_type}(jnp.asarray(x), axis=0)\n"
        f"    >>> want = scipy.fft.dst(x, type={dst_type})\n"
        f"    >>> bool(np.abs(np.asarray(got) - want).max() < 1e-4)\n"
        f"    True\n"
    )
    return f


nddst1 = _make_dst(1)
nddst2 = _make_dst(2)
nddst3 = _make_dst(3)
nddst4 = _make_dst(4)

# ``_par`` twins: there is no separate threaded path — batching is
# inherent — so the ``_par`` names take the reference's "use all the
# parallel hardware" intent (rayon over lanes, src/lib.rs:169-238) to the
# multi-device case: when called eagerly on an array sharded over a
# jax.sharding Mesh, they route through the pencil decomposition
# (all_to_all re-sharding if the transform axis itself is sharded).
# On unsharded/traced inputs they are exact synonyms of the serial names.


def _make_par(kind, serial_fn, handler_cls):
    real_input = kind in ("r2c", "dct1", "dct2", "dct3", "dct4",
                          "dst1", "dst2", "dst3", "dst4")

    def f(x, handler=None, axis: int = -1, **kw):
        # same dtype coercion as the serial twins (promote bf16/int, build
        # complex) BEFORE the sharding check, so sharded inputs behave
        # identically
        x = _prep_real(x) if real_input else _prep_complex(x)
        if isinstance(x, jax.core.Tracer):
            # inside a user jit the argument's sharding is invisible here
            # (tracers carry no committed sharding), so the EAGER pencil
            # path cannot be selected. Default ('spmd'): lower through a
            # custom_partitioning custom-call whose partition rule
            # performs the pencil axis rotation inside the SPMD
            # partitioner — a sharded transform axis costs tiled
            # all_to_alls, never an all-gather, and unsharded inputs
            # lower to the plain local impl (parallel/spmd.py; pinned by
            # tests/test_par_spmd.py). Legacy ('serial'): run the serial
            # impl and let GSPMD partition it, with a warning.
            from .config import config as _cfg

            use_spmd = _cfg.par_under_jit == "spmd"
            if use_spmd:
                from jax._src.interpreters.batching import BatchTracer

                if isinstance(x, BatchTracer):
                    # custom_partitioning has no batching rule: vmap
                    # falls back to the serial impl (numerically equal)
                    use_spmd = False
            if use_spmd:
                from .parallel.spmd import par_spmd_call

                a = _norm_axis(axis, x.ndim)
                if handler is None:
                    if kind == "c2r":
                        m = x.shape[a]
                        handler = _auto_handler(
                            handler_cls, kw.get("n") or 2 * (m - 1))
                    else:
                        handler = _auto_handler(handler_cls, x.shape[a])
                return par_spmd_call(kind, x, handler, a)
            if _cfg.par_under_jit == "serial" and _cfg.warn_par_under_jit:
                import warnings

                warnings.warn(
                    f"{serial_fn.__name__}_par was traced inside jit with "
                    "config.par_under_jit='serial': sharded inputs cannot "
                    "be detected under tracing, so the serial "
                    "implementation runs (harmless for unsharded/"
                    "replicated inputs; a mesh-sharded input gets GSPMD's "
                    "collectives instead of the pencil schedule). Use the "
                    "default par_under_jit='spmd', or "
                    "parallel.pencil.pencil_transform inside jit for the "
                    "explicit pencil schedule; "
                    "config.warn_par_under_jit=False silences this.",
                    stacklevel=2)
            return serial_fn(x, handler, axis, **kw)
        sharded = (
            hasattr(x, "sharding")
            and getattr(x.sharding, "mesh", None) is not None
            and not x.sharding.is_fully_replicated
        )
        if sharded:
            from .parallel.pencil import Step, pencil_transform

            mesh = x.sharding.mesh
            spec = x.sharding.spec
            a = _norm_axis(axis, x.ndim)
            if handler is None:
                if kind == "c2r":
                    m = x.shape[a]
                    handler = _auto_handler(
                        handler_cls, kw.get("n") or 2 * (m - 1))
                else:
                    handler = _auto_handler(handler_cls, x.shape[a])
            out, _ = pencil_transform(x, [Step(kind, a, handler)], mesh, spec)
            return out
        return serial_fn(x, handler, axis, **kw)

    f.__name__ = serial_fn.__name__ + "_par"
    f.__qualname__ = f.__name__
    f.__doc__ = (
        (serial_fn.__doc__ or "") +
        "\n\nParallel variant: on a mesh-sharded input array this runs the "
        "sharded pencil path (ndrustfft_tpu.parallel) with all_to_all "
        "re-sharding between devices; otherwise identical to the serial "
        "function."
    )
    return f


ndfft_par = _make_par("fft", ndfft, FftHandler)
ndifft_par = _make_par("ifft", ndifft, FftHandler)
ndfft_r2c_par = _make_par("r2c", ndfft_r2c, R2cFftHandler)
ndifft_r2c_par = _make_par("c2r", ndifft_r2c, R2cFftHandler)
nddct1_par = _make_par("dct1", nddct1, DctHandler)
nddct2_par = _make_par("dct2", nddct2, DctHandler)
nddct3_par = _make_par("dct3", nddct3, DctHandler)
nddct4_par = _make_par("dct4", nddct4, DctHandler)
nddst1_par = _make_par("dst1", nddst1, DstHandler)
nddst2_par = _make_par("dst2", nddst2, DstHandler)
nddst3_par = _make_par("dst3", nddst3, DstHandler)
nddst4_par = _make_par("dst4", nddst4, DstHandler)
