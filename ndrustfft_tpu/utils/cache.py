"""Persistent compilation cache (SURVEY.md §5 checkpoint/resume analog).

The reference's only persistent state is the rebuildable plan cache; the
analog here is XLA's persistent compilation cache keyed by the compiled
program — enabling it makes handler "planning" survive process restarts
the way rustfft plans survive within one.

Where the cache lives is a deployment setting: ``JAX_COMPILATION_CACHE_DIR``
when it is set (JAX itself reads it at import), otherwise a fixed directory
inside the checkout. The path is part of what makes a later process find
the entries, so it never depends on the home directory, a temporary name,
a pid or a time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <repo>/.jax_cache: this file is <repo>/ndrustfft_tpu/utils/cache.py
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The compile-cache directory: ``$JAX_COMPILATION_CACHE_DIR`` if set,
    else the fixed in-checkout ``.jax_cache``."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_persistent_cache(min_compile_seconds: float = 0.5) -> str:
    """Turn on JAX's on-disk compilation cache at :func:`cache_dir`.
    Returns the directory."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(ENV_VAR):
        # with the variable set, JAX already uses it: set no other dir
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_seconds)
    return path
