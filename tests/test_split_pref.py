"""Middle-axis transforms at the sizes whose stage splits have the most
factor choices (512 = 2^9, 1024 = 2^10, 2048 = 2^11).

The planner picks one factorization per size; whichever it picks, the
public transforms along the middle axis of (B, n, L) must match the
numpy/scipy float64 reference (rustdct convention = scipy / 2 under
``Normalization.NONE``).
"""

import numpy as np
import pytest
import scipy.fft as sp

import jax.numpy as jnp
from ndrustfft_tpu import (
    DctHandler, FftHandler, Normalization, R2cFftHandler, nddct2, nddct3,
    nddct4, ndfft, ndfft_r2c, ndifft_r2c,
)


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n", [512, 1024])
def test_dct23_split64_matches_scipy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n, 8)).astype(np.float32)
    h = DctHandler(n).normalization(Normalization.NONE)
    y2 = np.asarray(nddct2(jnp.asarray(x), h, axis=1))
    y3 = np.asarray(nddct3(jnp.asarray(x), h, axis=1))
    r2 = sp.dct(x.astype(np.float64), type=2, axis=1) / 2
    r3 = sp.dct(x.astype(np.float64), type=3, axis=1) / 2
    assert _rel(y2, r2) < 1e-4
    assert _rel(y3, r3) < 1e-4


def test_dct4_split64_matches_scipy():
    n = 2048
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, n, 8)).astype(np.float32)
    h = DctHandler(n).normalization(Normalization.NONE)
    y = np.asarray(nddct4(jnp.asarray(x), h, axis=1))
    r = sp.dct(x.astype(np.float64), type=4, axis=1) / 2
    assert _rel(y, r) < 1e-4


@pytest.mark.parametrize("n", [512, 1024])
def test_rfft_c2r_split64_roundtrip(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n, 8)).astype(np.float32)
    h = R2cFftHandler(n)
    s = ndfft_r2c(jnp.asarray(x), h, axis=1)
    ref = np.fft.rfft(x.astype(np.float64), axis=1)
    assert _rel(np.asarray(s), ref) < 1e-4
    back = np.asarray(ndifft_r2c(s, h, axis=1))
    assert np.abs(back - x).max() < 1e-4


def test_c2c_mid_split64_matches_numpy():
    n = 1024
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, n, 8))
         + 1j * rng.standard_normal((2, n, 8))).astype(np.complex64)
    got = np.asarray(ndfft(jnp.asarray(x), FftHandler(n), axis=1))
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    assert _rel(got, ref) < 1e-4
