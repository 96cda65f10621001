"""Runtime configuration for ndrustfft_tpu.

The reference exposes compile-time Cargo features (``parallel``, ``avx``,
``sse``, ``neon`` — reference Cargo.toml:34-39); this build replaces those
with runtime toggles: the precision of the DFT matmuls, the maximum base
radix the planner lowers to a dense DFT matmul before falling back to
Bluestein, and how ``_par`` entry points behave inside a user jit.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass


@dataclass
class _Config:
    # Precision of the f32 DFT matmuls (f64 dots are exact either way). On
    # an NVIDIA H100 80GB HBM3 at a 400 W power limit, at the reference
    # benchmark's shape (16 x 1024 x 1024, axes 1 and 2), 'highest' keeps
    # every f32 family at 2.0e-7..3.4e-7 x max|ref| against float64, and
    # 'high' (TF32-class) lands at 2.4e-4..5.1e-4 on every family but
    # DCT-I — 25-50x outside the 1e-5 tolerance the tests hold — while
    # running 1.4-1.9x slower on all but DST-I (1.0-2.3 ms per call at
    # 'highest', 1.55-4.2 ms at 'high'). chip_smoke.py prints both for
    # every family.
    #   'highest' = f32-exact dots (default)
    #   'high'    = TF32-class dots on the GPU
    #   'default' = the backend's fastest
    matmul_precision: str = os.environ.get("NDRUSTFFT_TPU_PRECISION", "highest")
    # Largest base DFT the planner emits as a dense matmul. Primes above this
    # route the whole transform through Bluestein (chirp-z).
    max_base_radix: int = int(os.environ.get("NDRUSTFFT_TPU_MAX_RADIX", "128"))
    # Opt-in dispatch observability: when True, each traced dispatch prints
    # one line to stderr stating (transform, n, axis) -> the chosen
    # execution path (engine / bluestein / moveaxis ...), so users can tell
    # which lowering a call compiled to (SURVEY.md §5 metrics decision:
    # optional debug-level plan logging only).
    debug_plan_log: bool = os.environ.get("NDRUSTFFT_TPU_DEBUG_PLAN", "0") in (
        "1", "true")
    # How a `_par` entry point traced inside a user jit executes:
    #   'spmd' (default) — a custom_partitioning custom-call: the SPMD
    #          partitioner rotates a sharded transform axis local with a
    #          tiled all_to_all (never an all-gather) and the serial impl
    #          runs per-shard — the reference's `_par` contract ("same
    #          call, parallel execution", src/lib.rs:169-238) inside jit
    #          (parallel/spmd.py). vmap-batched calls fall back to
    #          'serial' (custom_partitioning has no batching rule).
    #   'serial' — legacy (rounds 2-4): run the serial impl and let GSPMD
    #          partition it (typically contraction-dim all-reduces).
    par_under_jit: str = os.environ.get("NDRUSTFFT_TPU_PAR_JIT", "spmd")
    # Warn when a `_par` entry point is traced inside a user jit UNDER THE
    # LEGACY 'serial' MODE (a mesh-sharded input silently gets GSPMD's
    # collectives instead of a pencil-style schedule). No warning in
    # 'spmd' mode — the partitioned path honors the contract.
    warn_par_under_jit: bool = os.environ.get(
        "NDRUSTFFT_TPU_WARN_PAR_JIT", "1") in ("1", "true")
    # Axis-0 execution strategy for C2C:
    #   'moveaxis' (default) — transpose to lane-last and run the engine
    #   'einsum'   — first-axis contraction without any transpose
    axis0_strategy: str = os.environ.get("NDRUSTFFT_TPU_AXIS0", "moveaxis")


config = _Config()

# Thread-local precision override (precision_override below): a scoped,
# per-thread alternative to mutating config.matmul_precision, so a trace
# at another precision does not change the precision of transforms being
# traced concurrently on other threads.
_tls = threading.local()


def matmul_precision_name() -> str:
    """The effective precision NAME for the current thread (override-aware)."""
    return getattr(_tls, "precision", None) or config.matmul_precision


def matmul_precision():
    import jax

    return {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
        "default": jax.lax.Precision.DEFAULT,
    }[matmul_precision_name()]


class precision_override:
    """Context manager: force the matmul precision for the CURRENT THREAD
    only (trace-time scope; nestable)."""

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._prev = getattr(_tls, "precision", None)
        _tls.precision = self._name
        return self

    def __exit__(self, *exc):
        _tls.precision = self._prev
        return False
