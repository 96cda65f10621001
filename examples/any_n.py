"""Any-n capability demo: prime sizes and long transforms.

rustfft plans any n at full speed (Rader/Bluestein + mixed radix,
reference src/lib.rs:295-297). This build's equivalents:

* prime / rough n  -> Bluestein chirp-z over a 3-smooth padded length
* long n           -> the engine's multi-level Cooley-Tukey recursion

It checks both against numpy on whatever device JAX uses.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import FftHandler, ndfft, ndifft


def main():
    rng = np.random.default_rng(0)

    # prime length: 509 is prime, so no Cooley-Tukey factorization exists
    n = 509
    v = jnp.asarray(rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n)))
    h = FftHandler(n)
    vhat = ndfft(v, h, axis=1)
    np.testing.assert_allclose(np.asarray(vhat), np.fft.fft(np.asarray(v), axis=1),
                               rtol=1e-9, atol=1e-9)
    back = ndifft(vhat, h, axis=1)
    np.testing.assert_allclose(np.asarray(back), np.asarray(v),
                               rtol=1e-10, atol=1e-10)
    print(f"prime n={n} (Bluestein) roundtrip OK")

    # long transform: 2^18 = 262144 points
    n = 1 << 18
    v = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    h = FftHandler(n)
    vhat = ndfft(v, h, axis=0)
    np.testing.assert_allclose(np.asarray(vhat), np.fft.fft(np.asarray(v)),
                               rtol=1e-8, atol=1e-6)
    back = ndifft(vhat, h, axis=0)
    np.testing.assert_allclose(np.asarray(back), np.asarray(v),
                               rtol=1e-9, atol=1e-9)
    print(f"long n={n} (multi-level recursion) roundtrip OK")


if __name__ == "__main__":
    main()
