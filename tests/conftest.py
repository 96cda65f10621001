"""Test configuration: run on CPU with 8 virtual devices and x64 enabled.

Measurements run on the GPU (chip_smoke.py, bench.py); tests run on the host
CPU so that (a) f64 goldens hit the 1e-12 parity target and (b) multi-device sharding
is exercised on a virtual 8-device mesh (the standard
--xla_force_host_platform_device_count trick, SURVEY.md §4).
"""

import os
import re
import sys

# make the suite runnable from any cwd without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the suite hard-requires exactly 8 virtual devices (2x4 meshes): strip any
# pre-existing device-count flag and establish ours
flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
               os.environ.get("XLA_FLAGS", ""))
os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
