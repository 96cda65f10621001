"""Chained and loop-carried transforms: the caller's pattern in which each
call consumes the previous call's output, single calls on every layout,
``lax.fori_loop`` chains of transforms and of the fused spectral steps,
and a live input that must survive the call unchanged.

Reference capability analog: the reference's process_lane writes through
&mut output in place (reference src/lib.rs:316-341); here every call
returns a new array and the chains must match the float64 reference.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from ndrustfft_tpu import (
    DctHandler, FftHandler, Normalization, nddct2, ndfft, ndifft,
)


# (shape, axis, n) triples: minor and middle axes, multi-stage and
# single-stage plans, and a Bluestein prime
CASES = [
    ((32, 1024), -1, 1024),     # minor axis, two stages
    ((32, 64), -1, 64),         # minor axis, one dense stage
    ((2, 1024, 256), 1, 1024),  # middle axis, two stages
    ((2, 64, 256), 1, 64),      # middle axis, one dense stage
    ((2, 509, 256), 1, 509),    # middle axis, Bluestein
]


@pytest.mark.parametrize("shape,axis,n", CASES)
def test_donate_single_call_matches(shape, axis, n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
         ).astype(np.complex64)
    h = FftHandler(n)
    got = np.asarray(ndfft(jnp.asarray(x), h, axis=axis))
    ref = np.fft.fft(x.astype(np.complex128), axis=axis)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_donate_chained_loop_matches_numpy():
    # a fori_loop chain of scalar-normalized inverse transforms with the
    # input consumed each iteration
    n, K = 256, 5
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, n, 256)) + 1j
         * rng.standard_normal((2, n, 256))).astype(np.complex64)
    c = 1.001 / np.sqrt(n)
    h = FftHandler(n).normalization(Normalization.scalar(c))

    def chain(r, i):
        def body(_, carry):
            v = ndifft(jax.lax.complex(carry[0], carry[1]), h, axis=1)
            return (jnp.real(v), jnp.imag(v))

        return jax.lax.fori_loop(0, K, body, (r, i))

    ref = x.astype(np.complex128)
    for _ in range(K):
        ref = np.fft.ifft(ref, axis=1) * (c * n)

    rr, ii = jax.jit(chain)(jnp.asarray(x.real), jnp.asarray(x.imag))
    got = np.asarray(rr) + 1j * np.asarray(ii)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_donate_live_input_still_correct():
    # y = fft(x) with x STILL LIVE afterwards: the call must not clobber x
    n = 1024
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, n, 256)) + 1j
         * rng.standard_normal((2, n, 256))).astype(np.complex64)
    h = FftHandler(n)

    xj = jnp.asarray(x)
    y = ndfft(xj, h, axis=1)
    # x must be unchanged after the donated call
    np.testing.assert_array_equal(np.asarray(xj), x)
    ref = np.fft.fft(x, axis=1)
    assert (np.abs(np.asarray(y) - ref).max() / np.abs(ref).max()) < 1e-4


def test_donate_rr_bluestein_dct():
    # real-to-real DCT-II over a Bluestein-planned FFT (prime n)
    import scipy.fft as sf

    n = 509
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, n, 256)).astype(np.float32)
    h = DctHandler(n)
    got = np.asarray(nddct2(jnp.asarray(x), h, axis=1))
    ref = sf.dct(x.astype(np.float64), type=2, axis=1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_donate_dct_family_kernels():
    """DCT-I..IV on the middle axis at even and odd sizes match scipy."""
    import scipy.fft as sf

    from ndrustfft_tpu import nddct1, nddct3, nddct4

    rng = np.random.default_rng(7)
    cases = [
        (nddct2, 256, 2),
        (nddct3, 256, 3),
        (nddct1, 129, 1),
        (nddct4, 128, 4),
        (nddct1, 257, 1),
    ]
    for fn, n, t in cases:
        x = rng.standard_normal((2, n, 256)).astype(np.float32)
        got = np.asarray(fn(jnp.asarray(x), axis=1))
        ref = sf.dct(x.astype(np.float64), type=t, axis=1)
        np.testing.assert_allclose(got, ref, rtol=2e-4,
                                   atol=2e-4 * np.abs(ref).max())


def test_donate_chained_dct_pair_loop():
    """The DCT pair chain (dct3(dct2(x)) with the 2/n fold) inside a
    fori_loop: each step is the identity, so the chain returns x."""
    n = 256
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, n, 256)).astype(np.float32)
    h2 = DctHandler(n).normalization(Normalization.NONE)
    h3 = DctHandler(n).normalization(Normalization.scalar(2.0 / n))

    def chain(v):
        from ndrustfft_tpu import nddct3

        def body(_, c):
            return nddct3(nddct2(c, h2, axis=1), h3, axis=1)

        return jax.lax.fori_loop(0, 4, body, v)

    got = np.asarray(jax.jit(chain)(jnp.asarray(x)))
    np.testing.assert_allclose(got, x, rtol=1e-3, atol=1e-3)


def test_donate_chained_spectral_pipelines():
    # the fused spectral steps are same-shape real->real / c64->c64: chain
    # each in a fori_loop; each step is the identity times 1.001
    from ndrustfft_tpu import (
        DstHandler, R2cFftHandler, ndspectral_c2c, ndspectral_dct,
        ndspectral_dst, ndspectral_r2c,
    )

    n, K = 512, 3
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, n, 128)).astype(np.float32)
    Hr = np.ones(n // 2 + 1, np.float32)
    Hn = np.ones(n, np.float32)
    hr = R2cFftHandler(n).normalization(Normalization.scalar(1.001 / n))
    hc = FftHandler(n).normalization(Normalization.scalar(1.001 / n))
    hd2 = DctHandler(n).normalization(Normalization.NONE)
    hd3 = DctHandler(n).normalization(Normalization.scalar(2.002 / n))
    hs2 = DstHandler(n).normalization(Normalization.NONE)
    hs3 = DstHandler(n).normalization(Normalization.scalar(2.002 / n))

    cases = {
        "r2c": lambda v: ndspectral_r2c(v, Hr, hr, axis=1),
        "dct": lambda v: ndspectral_dct(v, Hn, hd2, hd3, axis=1),
        "dst": lambda v: ndspectral_dst(v, Hn, hs2, hs3, axis=1),
    }
    for name, step in cases.items():
        def chain(v, _s=step):
            return jax.lax.fori_loop(0, K, lambda _, c: _s(c), v)

        got = np.asarray(jax.jit(chain)(jnp.asarray(x)))
        # drift-chain oracle: each step is the scaled identity
        ref = x * (1.001 ** K)
        assert np.abs(got - ref).max() < 1e-3, name

    # complex pipeline
    xc = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)

    def chainc(r, i):
        def body(_, carry):
            v = ndspectral_c2c(jax.lax.complex(carry[0], carry[1]), Hn,
                               hc, axis=1)
            return (jnp.real(v), jnp.imag(v))

        return jax.lax.fori_loop(0, K, body, (jnp.real(xc_j),
                                              jnp.imag(xc_j)))

    xc_j = jnp.asarray(xc)
    rr, ii = jax.jit(chainc)(jnp.real(xc_j), jnp.imag(xc_j))
    got = np.asarray(rr) + 1j * np.asarray(ii)
    ref = xc * (1.001 ** K)
    assert np.abs(got - ref).max() < 1e-3
