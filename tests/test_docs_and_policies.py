"""Executable doc-examples + dtype/precision policy tests (round-2 items).

The reference ships a compiled, asserted doc-test on every public item
(src/lib.rs:34-51, 253-268, 353-366, 436-450, 545-558, 625-639, 754-769);
here pytest executes the docstring examples so they cannot rot.
"""

import doctest

import numpy as np
import pytest

import jax.numpy as jnp

import ndrustfft_tpu
import ndrustfft_tpu.api
import ndrustfft_tpu.handlers
import ndrustfft_tpu.normalization


@pytest.mark.parametrize("mod", [
    ndrustfft_tpu,
    ndrustfft_tpu.api,
    ndrustfft_tpu.handlers,
    ndrustfft_tpu.normalization,
])
def test_doctests(mod):
    res = doctest.testmod(mod, verbose=False)
    assert res.failed == 0, f"{res.failed} doctest failures in {mod.__name__}"
    assert res.attempted > 0, f"no doctests collected in {mod.__name__}"


def test_doctests_cover_every_public_fn_family():
    # handler classes + core fn docstrings each carry >>> examples
    for obj in (ndrustfft_tpu.FftHandler, ndrustfft_tpu.R2cFftHandler,
                ndrustfft_tpu.DctHandler, ndrustfft_tpu.ndfft,
                ndrustfft_tpu.ndifft, ndrustfft_tpu.ndfft_r2c,
                ndrustfft_tpu.ndifft_r2c, ndrustfft_tpu.nddct1,
                ndrustfft_tpu.nddct2, ndrustfft_tpu.nddct3,
                ndrustfft_tpu.nddct4):
        assert ">>>" in (obj.__doc__ or ""), obj


def test_dtype_reexports():
    # reference re-exports Complex/Zero/FftNum (src/lib.rs:83-85); the
    # framework exports the dtype vocabulary so one import serves user code
    assert ndrustfft_tpu.complex64 is jnp.complex64
    assert ndrustfft_tpu.float64 is jnp.float64
    assert ndrustfft_tpu.complex_dtype(ndrustfft_tpu.float32) == jnp.complex64
    assert ndrustfft_tpu.complex_dtype(np.float64) == jnp.complex128
    assert ndrustfft_tpu.real_dtype(np.complex128) == jnp.float64
    assert ndrustfft_tpu.real_dtype(np.float32) == jnp.float32


def test_f64_is_native():
    # end-to-end: f64 runs natively at full precision
    x = np.random.default_rng(0).standard_normal(16)
    got = np.asarray(ndrustfft_tpu.ndfft(jnp.asarray(x, jnp.complex128),
                                         axis=0))
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-12, atol=1e-12)


def test_max_base_radix_validation():
    from ndrustfft_tpu.plan import factorize

    with pytest.raises(ValueError, match="max_base_radix must be >= 3"):
        factorize(12, 2)
    old = ndrustfft_tpu.config.max_base_radix
    ndrustfft_tpu.config.max_base_radix = 1
    try:
        with pytest.raises(ValueError, match="max_base_radix"):
            factorize(12)
    finally:
        ndrustfft_tpu.config.max_base_radix = old


def test_precision_override_is_thread_local():
    """config.precision_override scopes a trace-time precision to the
    current thread: a concurrently traced transform on another thread keeps
    the configured precision."""
    import threading

    import jax

    from ndrustfft_tpu.config import (
        config, matmul_precision, precision_override,
    )

    seen = {}
    configured = matmul_precision()

    def other_thread():
        seen["p"] = matmul_precision()

    assert config.matmul_precision == "highest"   # the shipped default
    with precision_override("high"):
        assert matmul_precision() == jax.lax.Precision.HIGH
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
        # nested scope restores the outer override on exit
        with precision_override("default"):
            assert matmul_precision() == jax.lax.Precision.DEFAULT
        assert matmul_precision() == jax.lax.Precision.HIGH
    # other threads saw the configured precision, not the override
    assert seen["p"] == matmul_precision() == configured


def test_warmup_compiles_native_f64():
    """warmup(float64=True, run=False) AOT-compiles the native f64 entry
    that dispatch then uses: the first real f64 call finds it cached."""
    import ndrustfft_tpu.api as api
    from ndrustfft_tpu import FftHandler

    api._jitted.cache_clear()
    try:
        h = FftHandler(8)
        h.warmup((4, 8), float64=True, run=False)
        info = api._jitted.cache_info()
        x = np.random.default_rng(1).standard_normal((4, 8)) + 0j
        y = ndrustfft_tpu.ndfft(x, h, axis=1)
        assert api._jitted.cache_info().hits > info.hits
        assert y.dtype == jnp.complex128
        np.testing.assert_allclose(np.asarray(y), np.fft.fft(x, axis=1),
                                   rtol=1e-12, atol=1e-12)
    finally:
        api._jitted.cache_clear()
