"""Forward-mode sensitivity analysis through the spectral solver — the
round-5 twin of examples/spectral_adjoint.py.

The adjoint example uses reverse mode (one output, many inputs); this one
uses FORWARD mode, the right tool when perturbing a FEW parameters and
watching the WHOLE field: ``jax.jvp`` propagates a tangent through the
R2C forward, the spectral Poisson multiplier, and the C2R inverse in a
single pass. Through round 4 this raised on kernel routes (the custom_vjp
wrapper had no JVP rule); the round-5 engine-tangent ``custom_jvp``
(DESIGN.md §14) supports both modes, so the same public calls serve
grad AND jvp/linearize.

Checks, asserted:
  1. the Poisson solve is linear, so jvp(solve)(f; df) == solve(df);
  2. ``jax.linearize`` gives the reusable tangent map — three pushforwards
     from ONE linearization match three direct solves;
  3. a Hessian-vector product (forward-over-reverse) of the adjoint
     example's loss matches its analytic value for a quadratic loss:
     HVP(v) = 2 J^T J v.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import R2cFftHandler, FftHandler, ndfft, ndfft_r2c, ndifft, ndifft_r2c

n = 32
hr = R2cFftHandler(n)
hc = FftHandler(n)

kx = np.fft.rfftfreq(n) * n
ky = np.fft.fftfreq(n) * n
k2 = ky[:, None] ** 2 + kx[None, :] ** 2
inv_k2 = np.where(k2 == 0, 0.0, -1.0 / np.where(k2 == 0, 1.0, k2))
inv_k2 = jnp.asarray(inv_k2)


def solve(f):
    """Spectral periodic Poisson solve: lap(u) = f -> u (zero-mean)."""
    fhat = ndfft(ndfft_r2c(f, hr, axis=1), hc, axis=0)
    uhat = fhat * inv_k2
    return ndifft_r2c(ndifft(uhat, hc, axis=0), hr, axis=1)


rng = np.random.default_rng(0)
f0 = jnp.asarray(rng.standard_normal((n, n)))
df = jnp.asarray(rng.standard_normal((n, n)))

# 1. linearity: the pushforward of a linear solver IS the solver
u, du = jax.jvp(solve, (f0,), (df,))
err = float(jnp.abs(du - solve(df)).max())
print(f"jvp(solve) == solve(tangent): max err {err:.2e}")
assert err < 1e-11, err

# 2. linearize once, push many tangents
u2, tangent_map = jax.linearize(solve, f0)
assert float(jnp.abs(u2 - u).max()) < 1e-12
for seed in (1, 2, 3):
    v = jnp.asarray(rng.standard_normal((n, n)))
    err = float(jnp.abs(tangent_map(v) - solve(v)).max())
    assert err < 1e-11, err
print("linearize: 3 pushforwards from one linearization OK")

# 3. forward-over-reverse HVP of L(f) = ||solve(f) - u_obs||^2:
#    grad L = 2 J^T (solve(f) - u_obs), so HVP(v) = 2 J^T J v exactly
u_obs = solve(jnp.asarray(rng.standard_normal((n, n))))
loss = lambda f: jnp.sum((solve(f) - u_obs) ** 2)  # noqa: E731
hvp = jax.jvp(jax.grad(loss), (f0,), (df,))[1]
jt = jax.vjp(solve, f0)[1]
want = 2.0 * jt(solve(df))[0]
err = float(jnp.abs(hvp - want).max())
print(f"forward-over-reverse HVP vs analytic 2*J^T*J*v: max err {err:.2e}")
assert err < 1e-11, err
print("spectral sensitivity example OK")
