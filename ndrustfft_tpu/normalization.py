"""Normalization policy — parity with the reference's enum (src/lib.rs:89-98).

Semantics pinned from the reference:
  * C2C: forward applies NO normalization regardless of policy
    (src/lib.rs:313-318); the inverse applies the policy AFTER the transform
    (src/lib.rs:321-331). Default = multiply by 1/n.
  * R2C: forward applies nothing (src/lib.rs:497-503); C2R applies the policy
    to the half-spectrum BEFORE the inverse transform, with Default = 1/n
    over the FULL length n (src/lib.rs:506-531).
  * DCT 1-4: policy applied to the input lane BEFORE the transform
    (legal, the transform is linear); Default = multiply by 2, which converts
    the rustdct convention to scipy's unnormalized dct (src/lib.rs:688-741).

``Custom`` takes a callable replacing the reference's ``fn(&mut [T])``: it
receives a JAX array whose LAST axis is the transform lane (it may carry
arbitrary leading batch dimensions — lanes are batched instead of
iterated) and must return an array of the same shape/dtype. It must be
jax-traceable.
"""

from __future__ import annotations

from typing import Callable, Optional


class Normalization:
    """One of Normalization.NONE, Normalization.DEFAULT, Normalization.custom(fn).

    Example (reference examples/fft_norm.rs semantics)::

        >>> from ndrustfft_tpu import Normalization
        >>> Normalization.DEFAULT
        Normalization.DEFAULT
        >>> tripled = Normalization.custom(lambda v: v * 3.0)
        >>> tripled.kind
        'custom'
        >>> Normalization.DEFAULT == Normalization("default")
        True
    """

    __slots__ = ("kind", "fn", "value")

    def __init__(self, kind: str, fn: Optional[Callable] = None,
                 value: Optional[float] = None):
        if kind not in ("none", "default", "custom", "scalar"):
            raise ValueError(f"unknown normalization kind: {kind}")
        if kind == "custom" and fn is None:
            raise ValueError("Normalization.custom requires a callable")
        if kind == "scalar":
            if value is None:
                raise ValueError("Normalization.scalar requires a value")
            value = float(value)
        self.kind = kind
        self.fn = fn
        self.value = value

    # Rust-style constructors
    NONE: "Normalization"
    DEFAULT: "Normalization"

    @staticmethod
    def custom(fn: Callable) -> "Normalization":
        """Custom normalization callable (reference ``Normalization::Custom``).

        NOTE: custom policies hash/compare by the IDENTITY of ``fn`` (two
        lambdas with identical source are different policies — their
        closures may differ). Build the handler ONCE and reuse it; a fresh
        lambda per call would retrace and recompile on every call.
        """
        return Normalization("custom", fn)

    @staticmethod
    def scalar(value: float) -> "Normalization":
        """Multiply-by-constant normalization — an extension.

        Semantically equal to ``Normalization.custom(lambda v: v * value)``
        (and to the reference's ``Custom(fn)`` with a scaling fn), but the
        library folds a scalar policy into the transform's constants or its
        last stage's epilogue, costing no extra pass over the data — the
        analog of the reference applying ``*= 1/n`` inside the lane pass
        (src/lib.rs:333-338) instead of as a second sweep. The built-in
        DEFAULT policy uses the same fused path.

        Compile-cost note: because the scale is baked into the compiled
        program's constants, every DISTINCT scalar value (per transform
        size) compiles a fresh program, cached thereafter. A program
        sweeping many different scalar values on the same handler size will
        pay one compile per value and churn the jit caches — for that
        pattern prefer ``Normalization.custom(lambda v: v * s)`` (one
        compile, one extra elementwise pass) or apply the scale outside.
        """
        return Normalization("scalar", value=value)

    def __repr__(self):
        if self.kind == "custom":
            return f"Normalization.custom({self.fn!r})"
        if self.kind == "scalar":
            return f"Normalization.scalar({self.value!r})"
        return f"Normalization.{self.kind.upper()}"

    def __hash__(self):
        return hash((self.kind, id(self.fn), self.value))

    def __eq__(self, other):
        return (
            isinstance(other, Normalization)
            and self.kind == other.kind
            and self.fn is other.fn
            and self.value == other.value
        )


Normalization.NONE = Normalization("none")
Normalization.DEFAULT = Normalization("default")
