"""bench.py on the CPU: it refuses to measure anything but the GPU, and its
``--verify`` check runs every family at a tiny size, passes on the real
library and fails on a wrong transform (the full-size run needs the GPU)."""

import json

import numpy as np
import pytest

import bench
import ndrustfft_tpu

_SMALL = dict(n=64, cols=8, primes=(61,), long_n=1 << 12)


@pytest.fixture
def gpu_stub(monkeypatch):
    monkeypatch.setattr(bench, "_device", lambda: {
        "platform": "gpu", "kind": "stub", "count": 1, "xla_flags": ""})


def test_main_refuses_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["bench.py", "--verify"])
    with pytest.raises(RuntimeError, match="measures the GPU"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_verify_passes_every_family(gpu_stub, capsys):
    assert bench.verify(**_SMALL) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "family_verify" and row["pass"] is True
    errs = row["max_rel_errors"]
    assert {"c2c_64", "c2c_blue_61", "r2c_c2r_64", "dct2_33", "dct3_64",
            "dst2_64", "c2c_long_4096", "spectral_dct_64",
            "f64_c2c_64"} <= set(errs)
    assert errs["f64_c2c_64"] < 1e-10
    assert max(errs.values()) < 1e-5


def test_verify_fails_on_a_wrong_transform(gpu_stub, monkeypatch, capsys):
    real = ndrustfft_tpu.nddct2
    monkeypatch.setattr(ndrustfft_tpu, "nddct2",
                        lambda *a, **k: real(*a, **k) * np.float32(1.001))
    assert bench.verify(**_SMALL) == 1
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["pass"] is False
    assert row["max_rel_errors"]["dct2_64"] > 1e-5
