"""Distributed 3-D periodic Poisson solve in ONE call: spectral_pencil.

The round-5 distributed member of the fused-spectral family — forward
pencil rfftn, the diagonal 1/|k|^2 multiply device-local in the forward's
final pencil orientation (zero extra collectives beyond the transform's
own all_to_all hops), inverse pencil irfftn. No reference analog (the
reference is single-host; its users hand-compose the three steps —
reference src/lib.rs:543-611 + examples/rfft2.rs).

Runs on any device count (8 virtual CPU devices when
XLA_FLAGS=--xla_force_host_platform_device_count=8 is set, or the GPUs of
one host).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ndrustfft_tpu.parallel import spectral_pencil
from ndrustfft_tpu.utils.poisson import make_poisson_case


def main():
    ndev = len(jax.devices())
    py = int(np.floor(np.sqrt(ndev)))
    while ndev % py:
        py -= 1
    mesh = Mesh(np.array(jax.devices()).reshape(py, ndev // py), ("y", "z"))
    print(f"mesh: {dict(mesh.shape)}")

    nz, ny, nx = 32, 16, 32
    # -lap u = f with u = sin(2 t_z) cos(t_y) cos(3 t_x)
    u_exact, f, G = make_poisson_case((nz, ny, nx), (2, 1, 3))
    fs = jax.device_put(jnp.asarray(f, jnp.float32),
                        NamedSharding(mesh, P("y", "z", None)))

    u, _spec = spectral_pencil(fs, G.astype(np.complex64), mesh,
                               P("y", "z", None))
    err = float(np.abs(np.asarray(u) - u_exact).max())
    print(f"spectral_pencil Poisson on {ndev} devices, max err {err:.2e}")
    assert err < 1e-3
    print("poisson_pencil OK")


if __name__ == "__main__":
    main()
