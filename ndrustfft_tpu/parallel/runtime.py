"""Multi-process runtime: jax.distributed initialization helpers.

The reference is strictly single-process (SURVEY.md §2.3: no MPI/NCCL
anywhere in Cargo.lock); its only concurrency is a rayon thread pool. The
JAX equivalent of "use more hardware" beyond one host is a
multi-PROCESS JAX runtime: one process per host (or per chip group), a
coordinator service, and a global device mesh spanning every process —
after which the pencil layer (``ndrustfft_tpu.parallel.pencil``) works
unchanged, because ``shard_map``/``lax.all_to_all`` are process-agnostic
over a global mesh.

:func:`initialize` wraps ``jax.distributed.initialize`` with the ordering
pitfalls handled (environment flags must be set before first JAX use).
:func:`global_mesh` builds the most-square 2-D mesh over all global
devices. Cross-process operation is exercised end-to-end by
``__graft_entry__.dryrun_multichip(n, processes=2)`` and
tests/test_multiprocess.py, which launch real worker processes over a CPU
collectives backend — the same code path a multi-host GPU cluster uses.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence

__all__ = ["initialize", "global_mesh", "is_distributed"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               cpu_virtual_devices: Optional[int] = None) -> None:
    """Initialize the multi-process JAX runtime for this process.

    Must run before any other JAX call in the process. Pass the
    coordinator address, process count and process id explicitly: nothing
    on a plain GPU host or a CPU test topology lets JAX detect them.

    ``cpu_virtual_devices``: for CPU-backend runs (tests, dry runs), the
    number of virtual host devices THIS process contributes — sets
    ``--xla_force_host_platform_device_count`` and pins the platform to
    CPU, which must happen before JAX backend discovery.
    """
    import sys

    if cpu_virtual_devices is not None:
        if "jax" in sys.modules:
            bridge = getattr(getattr(sys.modules["jax"], "_src", None),
                             "xla_bridge", None)
            if getattr(bridge, "_backends", None):  # pragma: no cover
                raise RuntimeError(
                    "initialize(cpu_virtual_devices=...) must run before "
                    "first JAX use (backends already initialized)")
        flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                       os.environ.get("XLA_FLAGS", ""))
        os.environ["XLA_FLAGS"] = (
            flags +
            f" --xla_force_host_platform_device_count={cpu_virtual_devices}")
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    if cpu_virtual_devices is not None:
        jax.config.update("jax_platforms", "cpu")
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    if local_device_ids is not None:
        kw["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kw)


def is_distributed() -> bool:
    """True when this process is part of an initialized multi-process
    runtime (jax.process_count() > 1)."""
    import jax

    return jax.process_count() > 1


def global_mesh(names=("y", "z")):
    """Most-square 2-D mesh over ALL global devices (every process)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devs = jax.devices()
    n = len(devs)
    py = int(np.floor(np.sqrt(n)))
    while n % py:
        py -= 1
    return Mesh(np.array(devs).reshape(py, n // py), names)
