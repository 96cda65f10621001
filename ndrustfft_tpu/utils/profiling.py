"""Profiling and roofline accounting (SURVEY.md §5 tracing/profiling).

The reference's only perf tooling is criterion wall-times; this build adds
(a) a thin wrapper over the JAX profiler for trace capture, (b) one table
of device peaks keyed by ``device_kind`` so benchmark numbers can be
reported as a share of the device-memory roofline, and (c) a model of the
pencil layer's weak scaling over the device interconnect.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    """Published peaks of one device (dense rates, no sparsity)."""

    hbm_gbps: float       # device-memory bandwidth, GB/s
    f32_tflops: float     # float32 outside the tensor cores, TFLOP/s
    tf32_tflops: float    # TF32 tensor-core rate, TFLOP/s
    link_gbps: float      # interconnect to each other device, GB/s each way
    source: str


# Keyed by jax.Device.device_kind. A device that is not listed raises: a
# roofline share against a guessed peak is worse than none.
DEVICE_SPECS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        hbm_gbps=3350.0, f32_tflops=67.0, tf32_tflops=495.0,
        link_gbps=450.0,
        source="NVIDIA H100 Tensor Core GPU datasheet, SXM5 column; "
               "rates at the 700 W power limit"),
    # placeholder so the CPU tests can exercise the accounting; these are
    # not the peaks of any machine and no result is reported against them
    "cpu": DeviceSpec(hbm_gbps=50.0, f32_tflops=1.0, tf32_tflops=1.0,
                      link_gbps=10.0,
                      source="placeholder for CPU tests, not a device spec"),
}


def chip_spec(device=None) -> DeviceSpec:
    """The :class:`DeviceSpec` of ``device`` (default: the first device).

    Raises ``KeyError`` for a ``device_kind`` the table does not list."""
    import jax

    kind = (device or jax.devices()[0]).device_kind
    try:
        return DEVICE_SPECS[kind]
    except KeyError:
        raise KeyError(
            f"no peak table entry for device_kind {kind!r}; add its "
            f"published peaks to DEVICE_SPECS in {__name__}") from None


@dataclass
class Roofline:
    """Roofline verdict for one transform execution."""

    seconds: float
    flops: float
    bytes: float
    hbm_gbps: float
    peak_tflops: float

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9

    @property
    def achieved_gbps(self) -> float:
        return self.bytes / self.seconds / 1e9

    @property
    def hbm_bound_seconds(self) -> float:
        return self.bytes / (self.hbm_gbps * 1e9)

    @property
    def pct_of_hbm_roofline(self) -> float:
        """100 * (HBM-bound time / measured time)."""
        return 100.0 * self.hbm_bound_seconds / self.seconds

    def __str__(self):
        return (f"{self.gflops:.1f} GFLOP/s (5NlogN), "
                f"{self.achieved_gbps:.0f} GB/s, "
                f"{self.pct_of_hbm_roofline:.0f}% of HBM roofline")


def fft_flops(n: int, lanes: int) -> float:
    """5 N log2 N convention per lane (BASELINE.md metric)."""
    return 5.0 * n * math.log2(max(n, 2)) * lanes


def fft_bytes(n: int, lanes: int, itemsize: int, complex_io: bool = True) -> float:
    """Ideal HBM traffic: read input once + write output once."""
    per = 2 if complex_io else 1
    return 2.0 * lanes * n * itemsize * per


def measure(fn, *args, reps: int = 5, warmup: int = 2) -> float:
    """Median wall-time of fn(*args) with device sync."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def roofline_c2c(fn, x, n: int, lanes: int, reps: int = 5) -> Roofline:
    spec = chip_spec()
    secs = measure(fn, x, reps=reps)
    item = x.dtype.itemsize // (2 if "complex" in str(x.dtype) else 1)
    return Roofline(
        seconds=secs,
        flops=fft_flops(n, lanes),
        bytes=fft_bytes(n, lanes, item, complex_io=True),
        hbm_gbps=spec.hbm_gbps,
        peak_tflops=spec.f32_tflops,
    )


@dataclass
class PencilEstimate:
    """Model-based weak-scaling estimate for a pencil spectral pipeline."""

    t_compute: float       # seconds of on-device transform time per call
    t_comm: float          # seconds of all_to_all wire time per step call
    n_collectives: int
    efficiency_overlapped: float     # comm hidden behind compute where possible
    efficiency_sequential: float     # no overlap (conservative bound)

    def __str__(self):
        return (f"compute {self.t_compute*1e6:.1f} us + comm "
                f"{self.t_comm*1e6:.1f} us over {self.n_collectives} "
                f"all-to-alls: weak-scaling eff "
                f"{self.efficiency_overlapped*100:.0f}% overlapped / "
                f"{self.efficiency_sequential*100:.0f}% sequential")


def predict_pencil_weak_scaling(local_shape, mesh_shape, itemsize: int = 8,
                                n_transform_passes: int = 6,
                                hbm_fraction: float = 0.8,
                                hbm_gbps: float | None = None,
                                axis_bw: float | None = None,
                                wire_itemsize: int | None = None,
                                payload_complex: bool = True,
                                ) -> PencilEstimate:
    """Roofline model of weak-scaling efficiency for an rfftn+irfftn pencil
    pipeline on a (py, pz) mesh.

    Assumptions (documented, not measured): each of the
    ``n_transform_passes`` axis transforms costs one HBM read+write of the
    local complex volume at ``hbm_fraction`` of peak HBM bandwidth; each
    sharded-axis step performs one all_to_all moving local_bytes*(k-1)/k
    per device out over its links at ``axis_bw`` bytes/s (default: the
    device table's per-direction link rate); forward+inverse perform
    2 all-to-alls each on a 2-D mesh. Weak-scaling efficiency = single-chip
    time / multi-chip time for the same per-chip volume; with both terms
    linear in the local volume it depends only on the comm/compute ratio.
    Its output is a model, never a measurement.

    ``wire_itemsize`` models ``pencil_transform(wire_dtype=...)``: bytes on
    the wire scale by wire_itemsize/itemsize (bf16 wire on a complex64
    volume => 4/8, halving t_comm), while the compute term keeps the full
    working-dtype volume (the casts fuse into the local passes). A complex
    payload (``payload_complex``, the default) crosses the wire as TWO
    stacked real planes of ``wire_itemsize`` each; set False for a real
    payload so bf16 wire on f32 models its true 2x byte saving.
    """
    import numpy as np

    if hbm_gbps is None:
        hbm_gbps = chip_spec().hbm_gbps
    if axis_bw is None:
        axis_bw = chip_spec().link_gbps * 1e9
    v_bytes = float(np.prod(local_shape)) * itemsize
    planes = 2.0 if payload_complex else 1.0
    w_bytes = v_bytes * ((planes * wire_itemsize / itemsize)
                         if wire_itemsize else 1.0)
    t_pass = 2.0 * v_bytes / (hbm_fraction * hbm_gbps * 1e9)
    t_compute = n_transform_passes * t_pass
    t_comm = 0.0
    n_coll = 0
    for k in mesh_shape:
        if k > 1:
            # forward + inverse each re-shard once per mesh axis
            t_comm += 2.0 * w_bytes * (k - 1) / k / axis_bw
            n_coll += 2
    seq = t_compute / (t_compute + t_comm) if t_comm else 1.0
    ovl = t_compute / max(t_compute, t_comm) if t_comm else 1.0
    return PencilEstimate(t_compute, t_comm, n_coll, ovl, seq)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a JAX profiler trace around a block (view with xprof/tensorboard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
