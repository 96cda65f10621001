"""chip_smoke.py on the CPU: its device check refuses the CPU, its
reference-comparison helpers are right, its HLO overlap reader understands
both forms of async all-to-all, and every phase runs at a tiny size (the
full-size run needs the GPU)."""

import numpy as np
import pytest

import jax

import chip_smoke as cs


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


def test_check_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        cs.check_device(jax.devices())
    gpu = [_FakeDevice("gpu", "NVIDIA H100 80GB HBM3")]
    assert cs.check_device(gpu) == {"platform": "gpu",
                                    "kind": "NVIDIA H100 80GB HBM3",
                                    "count": 1}
    with pytest.raises(RuntimeError, match="need 4 GPUs"):
        cs.check_device(gpu, count=4)


def test_main_on_cpu_exits_without_a_result(capsys):
    with pytest.raises(RuntimeError):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_max_rel_err_reference_helper():
    ref = np.array([[1.0, -4.0], [2.0, 0.5]])
    assert cs.max_rel_err(ref.astype(np.float32), ref) == 0.0
    got = ref.copy()
    got[1, 0] += 0.02
    assert cs.max_rel_err(got, ref) == pytest.approx(0.02 / 4.0)
    # complex64 results against complex128 references
    refc = ref + 1j * ref[::-1]
    assert cs.max_rel_err(refc.astype(np.complex64), refc) < 1e-7
    assert cs.max_rel_err(ref[:1], ref) == float("inf")
    bad = ref.copy()
    bad[0, 0] = np.nan
    assert cs.max_rel_err(bad, ref) == float("inf")


def test_report_fails_on_a_missed_tolerance(capsys):
    rep = cs.Report()
    assert rep.check("within", 1e-6, 1e-5)
    assert not rep.check("beyond", 2e-5, 1e-5)
    assert not rep.check("nan", float("nan"), 1e-5)
    assert [f.split(":")[0] for f in rep.failures] == ["beyond", "nan"]
    out = capsys.readouterr().out
    assert "ok   within" in out and "FAIL beyond" in out


_HLO_SPLIT = """\
HloModule pencil, is_scheduled=true

%fused_mul (p0: f32[4,8]) -> f32[4,8] {
  %p0 = f32[4,8]{1,0} parameter(0)
  ROOT %m = f32[4,8]{1,0} multiply(%p0, %p0)
}

ENTRY %main (x: c64[8,8]) -> c64[8,8] {
  %x = c64[8,8]{1,0} parameter(0)
  %all-to-all-start.1 = (c64[8,8]{1,0}, c64[8,8]{1,0}) all-to-all-start(%x), channel_id=1, dimensions={0}
  %fusion.2 = f32[4,8]{1,0} fusion(%x), kind=kLoop, calls=%fused_mul
  %custom-call.3 = f32[4,8]{1,0} custom-call(%fusion.2), custom_call_target="__cublas$gemm"
  %all-to-all-done.1 = c64[8,8]{1,0} all-to-all-done(%all-to-all-start.1)
  %all-to-all-start.2 = (c64[8,8]{1,0}, c64[8,8]{1,0}) all-to-all-start(%all-to-all-done.1), channel_id=2, dimensions={1}
  %all-to-all-done.2 = c64[8,8]{1,0} all-to-all-done(%all-to-all-start.2)
  ROOT %fusion.4 = c64[8,8]{1,0} fusion(%all-to-all-done.2), kind=kLoop, calls=%fused_mul
}
"""

_HLO_ASYNC = """\
HloModule pencil, is_scheduled=true

%async_computation (p: c64[8,8]) -> c64[8,8] {
  %p = c64[8,8]{1,0} parameter(0)
  ROOT %a2a = c64[8,8]{1,0} all-to-all(%p), channel_id=1, dimensions={0}
}

ENTRY %main (x: c64[8,8]) -> c64[8,8] {
  %x = c64[8,8]{1,0} parameter(0)
  %async-start = ((c64[8,8]{1,0}), c64[8,8]{1,0}, s32[]) async-start(%x), calls=%async_computation
  %async-done = c64[8,8]{1,0} async-done(%async-start)
  ROOT %fusion = c64[8,8]{1,0} fusion(%async-done), kind=kLoop, calls=%async_computation
}
"""


def test_a2a_overlap_reads_both_async_forms():
    # start/done pairs: two starts, the fusion and the gemm inside the
    # first window, nothing inside the second
    assert cs.a2a_overlap(_HLO_SPLIT) == (2, 2)
    # async-start wrapping an all-to-all computation, nothing inside
    assert cs.a2a_overlap(_HLO_ASYNC) == (1, 0)
    # a plain synchronous all-to-all is no async window
    assert cs.a2a_overlap(_HLO_ASYNC.replace("async-start(", "copy(")) \
        == (0, 0)


def test_phase1_tiny_on_cpu(capsys):
    rep = cs.Report()
    cs.phase1(rep, shape=(2, 8, 8), reps=1)
    assert rep.failures == []
    out = capsys.readouterr().out
    # 16 families on both axes: an info line and a check line each, with
    # both precisions and the cuFFT op
    assert out.count("phase1 ") == 16 * 2 * 2
    assert "err[high]=" in out and "t[jnp.fft rfft]=" in out


def test_phases_2_to_4_tiny_on_cpu():
    rep = cs.Report()
    cs.phase2(rep, prime=131, prime_batch=2, odd=((9, 4), (17, 2)),
              long_log2=12, long_batch=2)
    cs.phase3(rep, edge=16, reps=1)
    cs.phase4(rep, shape=(2, 16, 16))
    assert rep.failures == []


def test_phase_four_tiny_on_virtual_devices(capsys):
    rep = cs.Report()
    cs.phase_four(rep, jax.devices()[:4], edge=16, par_shape=(4, 16, 16),
                  check_overlap=False)
    assert rep.failures == []
    out = capsys.readouterr().out
    assert "four 1x4 16^3" in out and "four 2x2 16^3" in out
