"""A fully-jitted, mesh-sharded pseudo-spectral solver step using the
``_par`` API inside ``jax.jit`` — the round-5 capability the pure-Rust
reference expresses only as "call the ``_par`` twin" (src/lib.rs:169-238).

Here the WHOLE solver step — forward 2-D FFT, spectral diffusion
multiplier, inverse — is one jit over a mesh-sharded state. Each
``_par`` call lowers through ``jax.experimental.custom_partitioning``
(parallel/spmd.py): the sharded transform axis is rotated device-local
by the SPMD partitioner with tiled all_to_all collectives (never an
all-gather), and the caller's sharding is restored — so the stepped state
keeps a stable sharding across iterations. Runs on every device JAX sees:
the GPUs of one host, or 8 virtual CPU devices with
XLA_FLAGS=--xla_force_host_platform_device_count=8.

Problem: heat equation u_t = nu * lap(u) on a periodic square, integrated
exactly in spectral space per step; asserted against the closed-form
single-mode decay.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax


import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ndrustfft_tpu import FftHandler, Normalization, ndfft_par, ndifft_par

n = 64
nu = 0.01
dt = 0.05
mesh = Mesh(np.array(jax.devices()), ("d",))

h = FftHandler(n)
hi = FftHandler(n)  # Default normalization: ifft applies 1/n per axis

# integrating factor exp(-nu |k|^2 dt) on the full complex spectrum
k = np.fft.fftfreq(n) * n
k2 = k[:, None] ** 2 + k[None, :] ** 2
decay = jnp.asarray(np.exp(-nu * k2 * dt), jnp.complex64)


@jax.jit
def step(u):
    # forward along both axes: axis 0 is SHARDED -> the partitioner runs
    # the pencil rotation; axis 1 is local -> the plain local transform
    uhat = ndfft_par(ndfft_par(u, h, axis=1), h, axis=0)
    uhat = uhat * decay
    return ndifft_par(ndifft_par(uhat, hi, axis=0), hi, axis=1)


# initial condition: one Fourier mode (m1, m2) => closed-form decay
m1, m2 = 3, 5
xg = np.arange(n) * (2 * np.pi / n)
u0 = np.cos(m1 * xg)[:, None] * np.cos(m2 * xg)[None, :]
u = jax.device_put(jnp.asarray(u0, jnp.complex64),
                   NamedSharding(mesh, P("d", None)))

steps = 20
for _ in range(steps):
    u = step(u)

# sharding is preserved across the whole stepped loop
assert u.sharding.spec == P("d", None), u.sharding

want = u0 * np.exp(-nu * (m1**2 + m2**2) * dt * steps)
err = float(np.abs(np.asarray(u).real - want).max())
print(f"heat step x{steps} on a sharded mesh: max err vs closed form "
      f"{err:.2e}")
assert err < 1e-4, err

# on several devices the compiled step uses all_to_all (the pencil
# rotation), never all-gather
hlo = step.lower(u).compile().as_text()
if len(jax.devices()) > 1:
    assert any("all-to-all" in ln for ln in hlo.splitlines())
assert not any("all-gather" in ln for ln in hlo.splitlines())
print("compiled step: all_to_all pencil rotation, zero all-gathers OK")
