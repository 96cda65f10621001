"""Plan-caching handler API — parity with the reference's three handler structs.

``FftHandler`` / ``R2cFftHandler`` / ``DctHandler`` mirror the reference
(src/lib.rs:269-348, 451-541, 640-751): construction eagerly builds the
transform schedule for length ``n`` (the analog of rustfft/realfft/rustdct
planning), ``.normalization(...)`` is the same builder method, and handlers
are immutable, shareable, and hashable — the JAX analog of ``&self`` handlers
with ``Arc`` plans being Sync (reference CHANGELOG 0.4.5).

Handlers hash by (type, n, normalization) so they can key jit caches.
"""

from __future__ import annotations

import copy

from .normalization import Normalization
from .plan import get_c2c_plan, get_r2c_plan


class _HandlerBase:
    __slots__ = ("n", "norm")

    def __init__(self, n: int):
        if not isinstance(n, int) or n <= 0:
            raise ValueError(f"transform length must be a positive int, got {n!r}")
        self.n = n
        self.norm = Normalization.DEFAULT

    def normalization(self, norm: Normalization) -> "_HandlerBase":
        """Builder: returns a new handler with the given normalization policy."""
        if not isinstance(norm, Normalization):
            raise TypeError(f"expected Normalization, got {type(norm).__name__}")
        new = copy.copy(self)
        new.norm = norm
        return new

    def __hash__(self):
        return hash((type(self).__name__, self.n, self.norm))

    def __eq__(self, other):
        return (
            type(self) is type(other) and self.n == other.n and self.norm == other.norm
        )

    def __repr__(self):
        return f"{type(self).__name__}(n={self.n}, norm={self.norm!r})"

    # transform kinds this handler serves: (kind, input_is_complex)
    _kinds: tuple = ()

    def warmup(self, shape, axis: int = -1, float64: bool = False,
               run: bool = True):
        """Precompile this handler's transforms for a forward-input shape.

        Serving-style precompilation: compiles every transform kind the
        handler serves (forward AND inverse, with the inverse input shape
        derived on the transform axis). With ``run=True`` (default) each
        compiled program is also EXECUTED once on zeros (blocking), which
        populates the jit dispatch cache — the first real call then
        neither traces nor compiles. This is the deployment analog of the
        reference's plan-once-use-forever handlers.

        ``run=False`` AOT-compiles only (no device execution); that alone
        does not populate the jit dispatch cache, so it is effective only
        together with ``utils.cache.enable_persistent_cache`` (the first
        real call then hits the on-disk XLA compilation cache instead of
        recompiling).
        """
        import jax
        import jax.numpy as jnp

        from . import api

        shape = tuple(shape)
        ax = axis % len(shape)
        cdt = jnp.complex128 if float64 else jnp.complex64
        rdt = jnp.float64 if float64 else jnp.float32
        for kind, is_cplx in self._kinds:
            s = list(shape)
            if kind == "c2r":
                s[ax] = getattr(self, "m")
            dt = cdt if is_cplx else rdt
            fn = api._jitted(kind, self, ax, api._config_key())
            if run:
                jax.block_until_ready(fn(jnp.zeros(tuple(s), dt)))
            else:
                fn.lower(jax.ShapeDtypeStruct(tuple(s), dt)).compile()
        return self


class FftHandler(_HandlerBase):
    """C2C FFT plan for axis length n (reference src/lib.rs:269-348).

    Example (reference doc example, src/lib.rs:253-268; executable)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import FftHandler, ndfft
        >>> nx, ny = 6, 4
        >>> data = jnp.ones((nx, ny), jnp.complex64)
        >>> handler = FftHandler(nx)
        >>> vhat = ndfft(data, handler, axis=0)
        >>> vhat.shape, vhat.dtype
        ((6, 4), dtype('complex64'))
        >>> bool(abs(vhat[0, 0] - 6.0) < 1e-5)   # DC bin = sum over axis 0
        True
    """

    _kinds = (("fft", True), ("ifft", True))

    def __init__(self, n: int):
        super().__init__(n)
        get_c2c_plan(n, -1)  # eager planning, like FftHandler::new
        get_c2c_plan(n, +1)


class R2cFftHandler(_HandlerBase):
    """R2C/C2R plan for REAL axis length n; spectrum length m = n//2 + 1
    (reference src/lib.rs:451-541).

    Example (reference doc example, src/lib.rs:436-450; executable)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import R2cFftHandler, ndfft_r2c
        >>> v = jnp.ones((6, 4))
        >>> handler = R2cFftHandler(4)
        >>> ndfft_r2c(v, handler, axis=1).shape   # m = 4//2 + 1 = 3 bins
        (6, 3)
    """

    __slots__ = ("m",)
    _kinds = (("r2c", False), ("c2r", True))

    def __init__(self, n: int):
        super().__init__(n)
        self.m = n // 2 + 1
        get_r2c_plan(n)
        get_c2c_plan(n, +1)


class DctHandler(_HandlerBase):
    """DCT-1/2/3/4 plans for axis length n (reference src/lib.rs:640-751).

    Like the reference, all four types are planned by one handler; the engine
    caches the underlying FFT schedules (2n-2, n, n, 2n) lazily on first use.

    Example (reference doc example, src/lib.rs:625-639; executable)::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import DctHandler, nddct1
        >>> data = jnp.ones((6, 4))
        >>> handler = DctHandler(4)
        >>> nddct1(data, handler, axis=1).shape
        (6, 4)
    """

    _kinds = (("dct1", False), ("dct2", False), ("dct3", False),
              ("dct4", False))


class DstHandler(_HandlerBase):
    """DST-1/2/3/4 plans for axis length n — beyond-parity extension.

    The reference exposes DCT only; its rustdct backend also ships DST 1-4
    and spectral Dirichlet problems need them, so this build completes the
    family. Same contract as :class:`DctHandler`: one handler plans all
    four types; Default normalization yields scipy.fft.dst values (the
    rustdct convention times 2, mirroring src/lib.rs:736-741). Types 2-4
    are flip/sign conjugations of the same-type DCT and ride every DCT
    execution path (ops/dst.py).

    Example::

        >>> import jax.numpy as jnp
        >>> from ndrustfft_tpu import DstHandler, nddst1
        >>> data = jnp.ones((6, 4))
        >>> handler = DstHandler(4)
        >>> nddst1(data, handler, axis=1).shape
        (6, 4)
    """

    _kinds = (("dst1", False), ("dst2", False), ("dst3", False),
              ("dst4", False))
