"""HLO-inspection tests for the distributed schedule (round-2 verdict #6).

Round 1 verified the pencil layer's OUTPUTS; these tests verify the compiled
SCHEDULE on the virtual 8-device mesh: (a) exactly one all-to-all per
sharded-axis step, (b) pipeline_chunks=k emits k independent collectives per
resharded step, (c) the bytes entering each all-to-all match the plan's
pad/slice accounting and the reduced wire formats' byte savings — so a
regression that silently doubles communication (or drops the padding
logic) fails here, not in a multi-card job. That the card's compiler
overlaps a chunk's all-to-all with compute is checked on four GPUs by
``chip_smoke.py --four``.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ndrustfft_tpu import FftHandler, R2cFftHandler
from ndrustfft_tpu.parallel.pencil import Step, pencil_transform, plan_pencil

# one tuple-shaped op line per collective:
#   %all-to-all.1 = (c64[4,2,4]{...}, ...) all-to-all(...)
_A2A_RE = re.compile(r"= \(([^)]*)\) all-to-all\(")
_SHAPE_RE = re.compile(r"(?:c64|c128|f32|f64)\[([\d,]*)\]")


def _mesh(shape=(2, 4), names=("y", "z")):
    return Mesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape),
                names)


def _compiled_hlo(fn, x):
    return jax.jit(fn).lower(x).compile().as_text()


def _a2a_ops(hlo: str):
    """[(total_elements, n_operands)] per all-to-all op in the HLO."""
    out = []
    for m in _A2A_RE.finditer(hlo):
        shapes = _SHAPE_RE.findall(m.group(1))
        elems = sum(int(np.prod([int(d) for d in s.split(",") if d]))
                    for s in shapes)
        out.append((elems, len(shapes)))
    return out


def _expected_a2a_elements(global_shape, steps, mesh, in_spec):
    """Simulate the plan: per resharded step, the LOCAL element count
    entering the all-to-all (= prod of local dims with the split dim padded
    to the plan's pad_b_to)."""
    plan, _, _, _, in_pad = plan_pencil(global_shape, steps, mesh, in_spec)
    spec = list(in_spec) + [None] * (len(global_shape) - len(in_spec))
    local = [g // mesh.shape[s] if s is not None else g
             for g, s in zip(in_pad, spec)]
    expected = []
    cur = list(local)
    for step, rs in zip(steps, plan):
        a = step.axis % len(global_shape)
        if rs is not None:
            k = mesh.shape[rs["name"]]
            b = rs["split"]
            entering = list(cur)
            entering[b] = rs["pad_b_to"]
            expected.append(int(np.prod(entering)))
            cur[b] = rs["pad_b_to"] // k
            cur[a] = rs["slice_a_to"]
        cur[a] = step.out_len(cur[a])
    return expected


def test_one_all_to_all_per_sharded_step():
    mesh = _mesh()
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 8, 16)),
                    jnp.complex64)
    x = jax.device_put(x, NamedSharding(mesh, P("y", "z", None)))
    steps = [Step("fft", 2, FftHandler(16)),   # local axis: no collective
             Step("fft", 1, FftHandler(8)),    # sharded by z: 1 all-to-all
             Step("fft", 0, FftHandler(8))]    # sharded by y: 1 all-to-all
    hlo = _compiled_hlo(
        lambda v: pencil_transform(v, steps, mesh, P("y", "z", None))[0], x)
    ops = _a2a_ops(hlo)
    assert len(ops) == 2, f"expected 2 all-to-alls, HLO has {len(ops)}"


def test_local_only_pipeline_has_no_collectives():
    mesh = _mesh()
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 8, 16)),
                    jnp.complex64)
    x = jax.device_put(x, NamedSharding(mesh, P("y", "z", None)))
    steps = [Step("fft", 2, FftHandler(16))]   # only the local axis
    hlo = _compiled_hlo(
        lambda v: pencil_transform(v, steps, mesh, P("y", "z", None))[0], x)
    assert len(_a2a_ops(hlo)) == 0


@pytest.mark.parametrize("chunks", [2, 4])
def test_pipeline_chunks_emit_independent_collectives(chunks):
    mesh = _mesh()
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 8, 16)),
                    jnp.complex64)
    x = jax.device_put(x, NamedSharding(mesh, P("y", "z", None)))
    steps = [Step("fft", 2, FftHandler(16)),
             Step("fft", 1, FftHandler(8)),
             Step("fft", 0, FftHandler(8))]
    hlo = _compiled_hlo(
        lambda v: pencil_transform(v, steps, mesh, P("y", "z", None),
                                   pipeline_chunks=chunks)[0], x)
    ops = _a2a_ops(hlo)
    # 2 resharded steps x `chunks` independent chunk collectives each
    assert len(ops) == 2 * chunks, (chunks, len(ops))


def test_bytes_on_wire_match_plan_accounting():
    mesh = _mesh()
    nz, ny, nx = 8, 8, 16
    x = jnp.asarray(np.random.default_rng(0).standard_normal((nz, ny, nx)),
                    jnp.float32)
    x = jax.device_put(x, NamedSharding(mesh, P("y", "z", None)))
    # r2c makes the last dim m = 9, indivisible by 4 and 2: exercises the
    # uneven padding in the accounting
    steps = [Step("r2c", 2, R2cFftHandler(nx)),
             Step("fft", 1, FftHandler(ny)),
             Step("fft", 0, FftHandler(nz))]
    hlo = _compiled_hlo(
        lambda v: pencil_transform(v, steps, mesh, P("y", "z", None))[0], x)
    got = [elems for elems, _ in _a2a_ops(hlo)]
    want = _expected_a2a_elements((nz, ny, nx), steps, mesh,
                                  (("y", "z", None)))
    assert sorted(got) == sorted(want), (got, want)


def test_a2a_operand_count_matches_mesh_axis_size():
    mesh = _mesh()
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 8, 16)),
                    jnp.complex64)
    x = jax.device_put(x, NamedSharding(mesh, P("y", "z", None)))
    steps = [Step("fft", 2, FftHandler(16)),
             Step("fft", 1, FftHandler(8)),    # over z: k = 4
             Step("fft", 0, FftHandler(8))]    # over y: k = 2
    hlo = _compiled_hlo(
        lambda v: pencil_transform(v, steps, mesh, P("y", "z", None))[0], x)
    counts = sorted(n for _, n in _a2a_ops(hlo))
    assert counts == [2, 4], counts


def _a2a_payload_bytes(hlo):
    # handles both the compiled tuple form `= (f32[..], ..) all-to-all(` and
    # the lowered single-shape form `= bf16[..]{layout} all-to-all(`
    total = 0
    for ln in hlo.splitlines():
        m = re.search(r"= (.*?) all-to-all\(", ln)
        if not m:
            continue
        for dt, dims in re.findall(
                r"(bf16|c64|c128|f32|f64|s16|u16)\[([\d,]*)\]",
                m.group(1)):
            sz = {"bf16": 2, "s16": 2, "u16": 2, "f32": 4, "c64": 8,
                  "f64": 8, "c128": 16}[dt]
            total += sz * int(np.prod([int(d) for d in dims.split(",")
                                       if d]))
    return total


def test_bf16_wire_rounding_applied_on_cpu_hlo():
    # On the CPU backend XLA promotes the collective payload back to f32
    # (its collectives don't carry bf16), but the PRECISION contract must
    # still hold: the payload is rounded through bf16 before the
    # all-to-all. The byte saving itself is asserted on the lowered program
    # (test_bf16_wire_halves_bytes_in_lowered_hlo).
    mesh = _mesh()
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 8, 16)),
                    jnp.complex64)
    x = jax.device_put(x, NamedSharding(mesh, P("y", "z", None)))
    steps = [Step("fft", 2, FftHandler(16)),
             Step("fft", 1, FftHandler(8)),
             Step("fft", 0, FftHandler(8))]

    def run(wire):
        return _compiled_hlo(
            lambda v: pencil_transform(v, steps, mesh, P("y", "z", None),
                                       wire_dtype=wire)[0], x)

    hlo32, hlo16 = run(None), run("bfloat16")
    # match the dtype-in-shape form `bf16[` — the bare string also appears
    # in op metadata (this test's own function name)
    assert "bf16[" in hlo16  # the rounding converts survive compilation
    assert "bf16[" not in hlo32


def _lowered_wire_bytes(wire):
    """all_to_all payload bytes of the lowered (pre-optimization) HLO of a
    3-D pencil FFT on the 2x4 CPU mesh: the program as the card's compiler
    receives it, before the CPU backend widens bf16 collectives to f32."""
    mesh = _mesh()
    steps = [Step("fft", 2, FftHandler(64)),
             Step("fft", 1, FftHandler(64)),
             Step("fft", 0, FftHandler(64))]
    fn = lambda v: pencil_transform(  # noqa: E731
        v, steps, mesh, P("y", "z", None), wire_dtype=wire)[0]
    xs = jax.ShapeDtypeStruct(
        (64, 64, 64), jnp.complex64,
        sharding=NamedSharding(mesh, P("y", "z", None)))
    return _a2a_payload_bytes(jax.jit(fn).lower(xs).as_text(dialect="hlo"))


def test_bf16_wire_halves_bytes_in_lowered_hlo():
    # wire_dtype='bfloat16' must carry HALF the bytes of the c64 payload; a
    # silent fallback to f32 wire would pass numerics but fail here
    b32 = _lowered_wire_bytes(None)
    b16 = _lowered_wire_bytes("bfloat16")
    # two resharded steps, each moving the local c64 volume (1/8 of 64^3)
    assert b32 == 2 * (64 ** 3 // 8) * 8, b32
    assert b16 * 2 == b32, (b16, b32)


def test_int16_wire_halves_bytes_in_lowered_hlo():
    """'int16' must move the SAME halved bytes as bf16 (its all_to_all
    payloads are s16 planes; the per-source scales ride a k-scalar
    all-gather whose bytes are noise), and 'bfloat16x2' on a c64 payload
    moves f32-EQUAL bytes (a precision tier, not a bandwidth tier, for
    f32-class grids)."""
    b32 = _lowered_wire_bytes(None)
    bq = _lowered_wire_bytes("int16")
    assert b32 > 0 and bq > 0
    assert bq * 2 == b32, (bq, b32)
    assert _lowered_wire_bytes("bfloat16x2") == b32


def test_bf16x2_split_rounds_with_reduce_precision():
    """The bf16x2 hi part is rounded by an explicit reduce-precision (8
    exponent, 7 mantissa bits), which survives into the compiled program:
    a bf16 round trip there may be folded away by XLA:GPU's excess-precision
    rewrites, leaving lo = 0 and plain-bf16 accuracy."""
    mesh = _mesh()
    steps = [Step("fft", 2, FftHandler(16)), Step("fft", 1, FftHandler(8))]
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 8, 16)),
                    jnp.complex64)
    x = jax.device_put(x, NamedSharding(mesh, P("y", "z", None)))
    hlo = _compiled_hlo(lambda v: pencil_transform(
        v, steps, mesh, P("y", "z", None), wire_dtype="bfloat16x2")[0], x)
    assert re.search(r"reduce-precision\(.*exponent_bits=8, mantissa_bits=7",
                     hlo), "bf16x2 hi rounding was folded away"
