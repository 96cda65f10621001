"""2-D mixed R2C + C2C pipeline — port of the reference's examples/rfft2.rs:
the canonical multi-dim real FFT composition (r2c along the LAST axis, C2C
along axis 0 on the half-spectrum)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

# f64 examples, like the reference's
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import FftHandler, R2cFftHandler, ndfft, ndfft_r2c


def main():
    nx, ny = 6, 4
    v = jnp.asarray(np.arange(nx * ny, dtype=np.float64).reshape(nx, ny))

    handler_y = R2cFftHandler(ny)   # real transform along the last axis
    handler_x = FftHandler(nx)      # complex transform along axis 0

    work = ndfft_r2c(v, handler_y, axis=1)   # (nx, ny//2+1)
    vhat = ndfft(work, handler_x, axis=0)

    expected = np.fft.fft(np.fft.rfft(np.asarray(v), axis=1), axis=0)
    np.testing.assert_allclose(np.asarray(vhat), expected, rtol=1e-9, atol=1e-9)
    print(np.asarray(vhat).round(3))
    print("rfft2 matches numpy OK")


if __name__ == "__main__":
    main()
