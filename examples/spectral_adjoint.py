"""Gradient-based source recovery through the spectral pipeline — the
adjoint-method workflow the pure-Rust reference cannot express (it has no
autodiff; reverse-mode through every transform is an extension of this
build, DESIGN.md §14).

Inverse problem: recover the source f of the periodic Poisson equation
lap(u) = f from an observation of u, by gradient descent on
L(f) = ||solve(f) - u_obs||^2 where solve() is the spectral solver of
examples/poisson.py. jax.grad differentiates straight through the
R2C forward, the spectral multiplier, and the C2R inverse; a k^4
spectral preconditioner on the adjoint gradient makes the quadratic
descent contract uniformly across modes, recovering the (zero-mean)
source to ~1e-8 in 25 steps — asserted below.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import (
    FftHandler, R2cFftHandler, ndfft, ndfft_r2c, ndifft, ndifft_r2c,
)


def main():
    n = 32
    hr = R2cFftHandler(n)
    hc = FftHandler(n)

    kx = np.fft.fftfreq(n, d=1.0 / n)
    ky = np.fft.rfftfreq(n, d=1.0 / n)
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2
    inv_k2 = np.where(k2 == 0, 0.0, -1.0 / np.where(k2 == 0, 1.0, k2))
    inv_k2 = jnp.asarray(inv_k2)

    def solve(f):
        # lap(u) = f  =>  u_hat = -f_hat / k^2   (zero-mean gauge);
        # R2C along the last axis then C2C along axis 0 — the reference's
        # canonical real 2-D composition (examples/rfft2.rs:29-33)
        fhat = ndfft(ndfft_r2c(f, hr, axis=1), hc, axis=0)
        return ndifft_r2c(ndifft(fhat * inv_k2, hc, axis=0), hr, axis=1)

    x = np.arange(n) * 2 * np.pi / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    f_true = np.sin(2 * X) * np.cos(3 * Y) + 0.5 * np.sin(5 * Y)
    u_obs = jnp.asarray(solve(jnp.asarray(f_true)))

    @jax.jit
    def loss_and_grad(f):
        return jax.value_and_grad(
            lambda v: jnp.sum((solve(v) - u_obs) ** 2))(f)

    # spectral preconditioner: the solve operator is diagonal in Fourier
    # with gain -1/k^2, so the loss Hessian is 2/k^4 — multiplying the
    # adjoint gradient by k^4 makes the descent contraction rate uniform
    # across modes (the classic physics-informed preconditioner)
    k4 = jnp.asarray(k2 ** 2)

    @jax.jit
    def precond(g):
        ghat = ndfft(ndfft_r2c(g, hr, axis=1), hc, axis=0)
        return ndifft_r2c(ndifft(ghat * k4, hc, axis=0), hr, axis=1)

    f = jnp.zeros((n, n))
    lr = 0.25  # preconditioned Hessian is exactly 2I: factor 0.5/step
    for _ in range(25):
        val, g = loss_and_grad(f)
        f = f - lr * precond(g)

    rel = float(jnp.max(jnp.abs(f - f_true)) / np.abs(f_true).max())
    print(f"recovered source: final loss {float(val):.3e}, "
          f"max rel err {rel:.3e}")
    assert rel < 1e-3, rel
    print("OK")


if __name__ == "__main__":
    main()
