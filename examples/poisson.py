"""Spectral Poisson solver on a periodic box — the reference's home domain
(ndrustfft was written for spectral PDE codes).

Solves lap(u) = f on [0, 2pi)^2 with the R2C pipeline: forward transform,
divide by -(kx^2 + ky^2), inverse transform. Validated against an analytic
solution. Runs on one device; the same spectral step scales to a mesh via
ndrustfft_tpu.parallel (see examples/pencil3d.py).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

# f64 example, like the reference's
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import FftHandler, R2cFftHandler, ndfft, ndfft_r2c, ndifft, ndifft_r2c


def main():
    n = 64
    h_r2c = R2cFftHandler(n)
    h_c2c = FftHandler(n)

    x = np.arange(n) * 2 * np.pi / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    # analytic: u = sin(3x)cos(5y)  =>  f = lap u = -(9+25) u
    u_exact = np.sin(3 * X) * np.cos(5 * Y)
    f = -(9 + 25) * u_exact

    kx = np.fft.fftfreq(n, d=1.0 / n)          # integer wavenumbers
    ky = np.fft.rfftfreq(n, d=1.0 / n)
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2
    inv_k2 = np.where(k2 == 0, 0.0, -1.0 / np.where(k2 == 0, 1.0, k2))

    @jax.jit
    def solve(rhs):
        fhat = ndfft(ndfft_r2c(rhs, h_r2c, axis=1), h_c2c, axis=0)
        uhat = fhat * jnp.asarray(inv_k2)
        return ndifft_r2c(ndifft(uhat, h_c2c, axis=0), h_r2c, axis=1)

    u = np.asarray(solve(jnp.asarray(f)))
    err = np.abs(u - u_exact).max()
    print(f"Poisson 2-D spectral solve, n={n}: max err {err:.2e}")
    assert err < 1e-10
    print("poisson OK")


if __name__ == "__main__":
    main()
