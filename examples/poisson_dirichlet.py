"""Spectral Poisson solver with homogeneous Dirichlet walls — the DST's
home domain (beyond-parity: the reference exposes DCT only, ops/dst.py).

Solves lap(u) = f on (0, pi)^2 with u = 0 on the boundary by sine-series
diagonalization: DST-I maps interior samples u(x_i), x_i = (i+1) pi/(n+1)
to coefficients of sum a_{jk} sin(j x) sin(k y), where the Laplacian is the
diagonal -(j^2 + k^2). Forward DST-I both axes, divide, inverse DST-I —
the Dirichlet twin of examples/poisson.py's periodic R2C pipeline.
Validated against an analytic solution (a pure sine mode, so the spectral
solve is exact to roundoff).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

# f64 example, like the reference's
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import DstHandler, nddst1, Normalization


def main():
    n = 63                                    # interior points per axis
    x = (np.arange(n) + 1) * np.pi / (n + 1)  # open interval (0, pi)
    X, Y = np.meshgrid(x, x, indexing="ij")
    # analytic: u = sin(3x) sin(5y) => f = lap u = -(9+25) u, u|boundary = 0
    u_exact = np.sin(3 * X) * np.sin(5 * Y)
    f = -(9 + 25) * u_exact

    j = np.arange(1, n + 1)                   # DST-I bin k holds mode j=k+1
    k2 = j[:, None] ** 2 + j[None, :] ** 2
    # forward uses Default (scipy values); the inverse's 1/(2(n+1)) per axis
    # folds into the fused scalar normalization (zero extra HBM passes)
    h_fwd = DstHandler(n)
    h_inv = DstHandler(n).normalization(Normalization.scalar(1.0 / (n + 1)))

    @jax.jit
    def solve(rhs):
        fhat = nddst1(nddst1(rhs, h_fwd, axis=1), h_fwd, axis=0)
        uhat = -fhat / jnp.asarray(k2, rhs.dtype)
        return nddst1(nddst1(uhat, h_inv, axis=0), h_inv, axis=1)

    u = np.asarray(solve(jnp.asarray(f)))
    err = np.abs(u - u_exact).max()
    print(f"poisson_dirichlet: n={n}^2 interior, max |u - u_exact| = {err:.3e}")
    assert err < 1e-12, err
    # the solve really imposes u = 0 on the walls: extend and check edges
    full = np.zeros((n + 2, n + 2))
    full[1:-1, 1:-1] = u
    assert abs(full[0].max()) == 0.0 and abs(full[-1].max()) == 0.0
    print("poisson_dirichlet: OK")


if __name__ == "__main__":
    main()
