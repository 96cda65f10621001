"""The example programs double as asserted integration tests (the reference's
examples panic on mismatch, examples/fft2.rs:47-51)."""

import os
import subprocess
import sys

import pytest

EXAMPLES = ["fft1", "fft2", "rfft2", "fft_norm", "poisson", "pencil3d",
            "any_n", "vorticity2d", "poisson_dirichlet", "spectral_adjoint",
            "spectral_sensitivity", "jit_spectral_step", "fused_filter",
            "poisson_pencil"]
_EX_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "examples")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name):
    r = subprocess.run(
        [sys.executable, os.path.join(_EX_DIR, f"{name}.py")],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "HOME": os.environ.get("HOME", ""),
             "XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout
