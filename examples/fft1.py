"""1-D C2C FFT roundtrip — port of the reference's examples/fft1.rs."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

# f64 examples, like the reference's
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import FftHandler, ndfft, ndifft


def main():
    n = 10
    v = jnp.asarray(np.arange(n, dtype=np.float64) + 0j)
    handler = FftHandler(n)
    vhat = ndfft(v, handler, axis=0)
    v2 = ndifft(vhat, handler, axis=0)
    print(np.asarray(vhat))
    print(np.asarray(v2))
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v), rtol=1e-6, atol=1e-6)
    print("fft1 roundtrip OK")


if __name__ == "__main__":
    main()
