"""Weak-scaling measurement for the pencil-decomposed 3-D R2C pipeline.

Holds the per-device volume constant while the mesh grows over the devices
JAX sees (the GPUs of one host, or N virtual CPU devices with
XLA_FLAGS=--xla_force_host_platform_device_count=N, which validates the
machinery only: virtual devices share one machine's cores). Prints a
model estimate from the device table first, then the measured rows.

Usage:
  python benches/pencil_scaling.py [--base 32]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=int, default=32,
                    help="per-device cube edge (weak scaling)")
    args = ap.parse_args()

    import jax
    import numpy as np

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from ndrustfft_tpu.parallel import irfftn_pencil, rfftn_pencil

    ndev_all = len(jax.devices())
    if jax.default_backend() == "cpu":
        print("# NOTE: virtual CPU devices share one machine's cores — this"
              " validates the sharding machinery, NOT scaling efficiency;"
              " apparent efficiency degrades ~1/N by construction.")

    # roofline model of the same pipeline at 256^3 per device on the most
    # square mesh of all devices, from the device table (a model, not a
    # measurement; its comm accounting is pinned by
    # tests/test_hlo_schedule.py)
    from ndrustfft_tpu.utils.profiling import (
        chip_spec, predict_pencil_weak_scaling,
    )

    py = int(np.floor(np.sqrt(ndev_all)))
    while ndev_all % py:
        py -= 1
    spec = chip_spec()
    for wire, item in ((None, None), ("bfloat16 / int16", 2)):
        est = predict_pencil_weak_scaling(
            local_shape=(256, 256, 256), mesh_shape=(py, ndev_all // py),
            itemsize=8, wire_itemsize=item)
        print(f"# MODEL {jax.devices()[0].device_kind} "
              f"({spec.hbm_gbps:.0f} GB/s, links {spec.link_gbps:.0f} GB/s) "
              f"{py}x{ndev_all // py} mesh, 256^3 per device, wire "
              f"{wire or 'f32'}: {est}")
    results = {}
    counts = [d for d in [1, 2, 4, 8, 16, 32, 64] if d <= ndev_all]
    for ndev in counts:
        py = int(np.floor(np.sqrt(ndev)))
        while ndev % py:
            py -= 1
        pz = ndev // py
        mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(py, pz), ("y", "z"))
        # weak scaling: volume grows with device count
        nz, ny, nx = args.base * py, args.base * pz, args.base
        rng = np.random.default_rng(0)
        v = jnp.asarray(rng.standard_normal((nz, ny, nx)), dtype=jnp.float32)
        v = jax.device_put(v, NamedSharding(mesh, P("y", "z", None)))

        @jax.jit
        def step(u, _mesh=mesh, _nx=nx):
            uhat, spec = rfftn_pencil(u, _mesh, P("y", "z", None))
            return irfftn_pencil(uhat, _mesh, spec, n_last=_nx,
                                 axes=[0, 1, 2])[0]

        jax.block_until_ready(step(v))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(step(v))
            ts.append(time.perf_counter() - t0)
        t = sorted(ts)[1]
        results[ndev] = t
        eff = results[counts[0]] / t * 100.0
        print(f"devices={ndev:3d} grid={nz}x{ny}x{nx}: {t*1e3:8.2f} ms  "
              f"weak-scaling eff {eff:5.1f}%")

    # chunked-vs-unchunked A/B: same full-mesh pipeline with
    # pipeline_chunks in {1, 2, 4} and each wire format; JSON lines. On the
    # CPU mesh collectives execute synchronously, so there this records
    # machinery overhead, NOT the overlap win (which chip_smoke.py --four
    # checks in the GPU-compiled schedule).
    import json

    ndev = counts[-1]
    py = int(np.floor(np.sqrt(ndev)))
    while ndev % py:
        py -= 1
    pz = ndev // py
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(py, pz), ("y", "z"))
    nz, ny, nx = args.base * py, args.base * pz, args.base
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((nz, ny, nx)), dtype=jnp.float32)
    v = jax.device_put(v, NamedSharding(mesh, P("y", "z", None)))
    # on the virtual CPU mesh chunking buys no overlap and pays chunk
    # dispatch + per-chunk pad/slice + the final concatenate: a monotonic
    # slowdown is the expected CPU result
    for chunks in (1, 2, 4):
        for wire in (None, "bfloat16", "int16", "bfloat16x2"):
            @jax.jit
            def step(u, _mesh=mesh, _nx=nx, _c=chunks, _w=wire):
                uhat, spec = rfftn_pencil(u, _mesh, P("y", "z", None),
                                          pipeline_chunks=_c, wire_dtype=_w)
                return irfftn_pencil(uhat, _mesh, spec, n_last=_nx,
                                     axes=[0, 1, 2], pipeline_chunks=_c,
                                     wire_dtype=_w)[0]

            jax.block_until_ready(step(v))
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(step(v))
                ts.append(time.perf_counter() - t0)
            print(json.dumps({
                "metric": (f"pencil_ab_chunks{chunks}"
                           + (f"_{wire}wire".replace("bfloat16", "bf16")
                              if wire else "")),
                "devices": ndev, "grid": [nz, ny, nx],
                "unit": "ms/roundtrip",
                "value": round(sorted(ts)[len(ts) // 2] * 1e3, 3),
                "backend": jax.default_backend(),
                "device_kind": jax.devices()[0].device_kind,
            }))


if __name__ == "__main__":
    main()
