"""2-D C2C FFT along both axes — port of the reference's examples/fft2.rs
(per-axis handlers + explicit intermediate), asserted against numpy."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

# f64 examples, like the reference's
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import FftHandler, ndfft

def main():
    nx, ny = 6, 4
    data = np.arange(nx * ny, dtype=np.float64).reshape(nx, ny)
    v = jnp.asarray(data + 1j * data)

    handler_x = FftHandler(nx)
    handler_y = FftHandler(ny)

    work = ndfft(v, handler_y, axis=1)   # transform along y first
    vhat = ndfft(work, handler_x, axis=0)

    expected = np.fft.fft(np.fft.fft(np.asarray(v), axis=1), axis=0)
    np.testing.assert_allclose(np.asarray(vhat), expected, rtol=1e-9, atol=1e-9)
    print(np.asarray(vhat).round(3))
    print("fft2 matches numpy fft2 OK")


if __name__ == "__main__":
    main()
