"""Smoke test of ndrustfft_tpu on NVIDIA GPUs: the quickest proof that the
library's main path compiles, runs and is right on the card.

``python chip_smoke.py`` needs one GPU and runs five phases through the
public entry points (``import ndrustfft_tpu``, its functions, ``ndapi``),
each call under ``jax.jit`` with ``block_until_ready`` before the host
check, and compares every result on the host with numpy/scipy in float64:

0. device: refuse anything but a GPU; print the card's name and power
   limit, JAX's version, ``XLA_FLAGS`` and the compile-cache directory;
1. every transform family at the reference benchmark's shape
   (benches/ndrustfft.rs: 1024 x 1024 slices, here 16 of them, 128 MB in
   complex64) along a non-minor and the minor axis, with the max-rel error
   at matmul precision 'highest' and 'high' and the median time of the
   library's route beside ``jnp.fft`` (cuFFT) on the same input;
2. awkward sizes: a prime (Bluestein), odd DCT sizes, one 2^20-point
   transform;
3. a periodic Poisson solve on a 512^3 float32 grid in one jit, against
   the analytic solution, and the ``__graft_entry__`` rfft2 step;
4. native float64 at 1e-10.

``python chip_smoke.py --four`` needs four GPUs and runs only the pencil
layer and what it is compared with: ``rfftn_pencil``/``irfftn_pencil`` on
1x4 and 2x2 meshes over a 512^3 grid against single-card ``rfftn``, three
wire formats, ``spectral_pencil`` against the analytic Poisson solution,
``ndfft_par`` under jit on a sharded input against the serial call, and
the all-to-all/compute overlap in the GPU-compiled HLO.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
printed only when every check passed; any failed check exits non-zero.
One process drives every card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# max|got - ref| <= tol * max|ref| against the float64 reference: the f32
# tolerance of the CPU tests (tests/test_c2c.py) and the f64 one
F32_TOL = 1e-5
F64_TOL = 1e-10
# absolute roundtrip error of a standard-normal grid through the pencil
# layer, per wire format (__graft_entry__.dryrun_multichip's tiers)
WIRE_TOL = {None: 1e-3, "bfloat16x2": 1e-3, "int16": 1e-2}


class Report:
    """Collects the checks of a run; a failed check fails the run."""

    def __init__(self):
        self.failures = []

    def check(self, name, err, tol):
        ok = bool(np.isfinite(err)) and err <= tol
        print(f"{'ok  ' if ok else 'FAIL'} {name}: max-rel err {err:.3e} "
              f"(tol {tol:.0e})", flush=True)
        if not ok:
            self.failures.append(f"{name}: {err:.3e} > {tol:.0e}")
        return ok


def check_device(devices, count=1):
    """The device facts of a GPU run; raises on any other platform or on
    fewer than ``count`` devices."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"chip_smoke.py needs an NVIDIA GPU; JAX found platform "
            f"{dev.platform!r} ({dev.device_kind})")
    if len(devices) < count:
        raise RuntimeError(f"need {count} GPUs, JAX found {len(devices)}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def max_rel_err(got, ref):
    """max|got - ref| / max|ref| on the host in float64 (inf if ``got`` is
    not finite or has the wrong shape)."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return float("inf")
    scale = float(np.max(np.abs(ref))) or 1.0
    return float(np.max(np.abs(got.astype(ref.dtype) - ref))) / scale


def _along(mult, ndim, axis):
    shape = [1] * ndim
    shape[axis] = mult.shape[0]
    return mult.reshape(shape)


def _ms(fn, *args, reps=5):
    from ndrustfft_tpu.utils.profiling import measure

    return 1e3 * measure(fn, *args, reps=reps, warmup=1)


def _run(fn, *args):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    return out


# --------------------------------------------------------------------------
# phase 0
# --------------------------------------------------------------------------


def gpu_name_and_power(count=1):
    """``name, power.limit`` of the first ``count`` cards, as nvidia-smi
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.strip().splitlines()][:count]


def phase0(count):
    import jax

    from ndrustfft_tpu.config import config
    from ndrustfft_tpu.utils.cache import enable_persistent_cache

    device = check_device(jax.devices(), count)
    for line in gpu_name_and_power(count):
        print(f"nvidia-smi: {line}", flush=True)
    print(f"device_kind: {device['kind']} x{device['count']}; jax "
          f"{jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {enable_persistent_cache()}")
    print(f"shipped matmul precision: {config.matmul_precision}", flush=True)
    return device


# --------------------------------------------------------------------------
# phase 1: every family at the reference benchmark's shape
# --------------------------------------------------------------------------


def _families(n, rng):
    """(name, input kind, library call, float64 reference, cuFFT op)."""
    import scipy.fft as sf

    import ndrustfft_tpu as nd

    m = n // 2 + 1
    hc = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)
    hr = rng.standard_normal(n).astype(np.float32)
    hm = (rng.standard_normal(m) + 1j * rng.standard_normal(m)
          ).astype(np.complex64)
    w = {"workers": -1}

    def spec_r2c_ref(v, a):
        s = sf.rfft(v, axis=a, **w) * _along(hm, v.ndim, a)
        # the reference zeroes the DC/Nyquist imag before the inverse
        for k in (0, m - 1):
            idx = [slice(None)] * v.ndim
            idx[a] = k
            s[tuple(idx)] = s[tuple(idx)].real
        return sf.irfft(s, n=n, axis=a, **w)

    fams = [
        ("ndfft", "c", lambda v, a: nd.ndfft(v, axis=a),
         lambda v, a: sf.fft(v, axis=a, **w), "fft"),
        ("ndifft", "c", lambda v, a: nd.ndifft(v, axis=a),
         lambda v, a: sf.ifft(v, axis=a, **w), "ifft"),
        ("ndfft_r2c", "r", lambda v, a: nd.ndfft_r2c(v, axis=a),
         lambda v, a: sf.rfft(v, axis=a, **w), "rfft"),
        ("ndifft_r2c", "s", lambda v, a: nd.ndifft_r2c(v, axis=a, n=n),
         lambda v, a: sf.irfft(v, n=n, axis=a, **w), "irfft"),
    ]
    for t in (1, 2, 3, 4):
        fams.append((f"nddct{t}", "r",
                     lambda v, a, _t=t: getattr(nd, f"nddct{_t}")(v, axis=a),
                     lambda v, a, _t=t: sf.dct(v, type=_t, axis=a, **w),
                     "rfft"))
    for t in (1, 2, 3, 4):
        fams.append((f"nddst{t}", "r",
                     lambda v, a, _t=t: getattr(nd, f"nddst{_t}")(v, axis=a),
                     lambda v, a, _t=t: sf.dst(v, type=_t, axis=a, **w),
                     "rfft"))
    fams += [
        ("ndspectral_r2c", "r",
         lambda v, a: nd.ndspectral_r2c(v, hm, axis=a), spec_r2c_ref,
         "rfft*H+irfft"),
        ("ndspectral_c2c", "c",
         lambda v, a: nd.ndspectral_c2c(v, hc, axis=a),
         lambda v, a: sf.ifft(_along(hc, v.ndim, a)
                              * sf.fft(v, axis=a, **w), axis=a, **w),
         "fft*H+ifft"),
        ("ndspectral_dct", "r",
         lambda v, a: nd.ndspectral_dct(v, hr, axis=a),
         lambda v, a: sf.dct(_along(hr, v.ndim, a)
                             * sf.dct(v, type=2, axis=a, **w),
                             type=3, axis=a, **w), "rfft*H+irfft"),
        ("ndspectral_dst", "r",
         lambda v, a: nd.ndspectral_dst(v, hr, axis=a),
         lambda v, a: sf.dst(_along(hr, v.ndim, a)
                             * sf.dst(v, type=2, axis=a, **w),
                             type=3, axis=a, **w), "rfft*H+irfft"),
    ]
    cufft = {
        "fft": lambda v, a: _jnp().fft.fft(v, axis=a),
        "ifft": lambda v, a: _jnp().fft.ifft(v, axis=a),
        "rfft": lambda v, a: _jnp().fft.rfft(v, axis=a),
        "irfft": lambda v, a: _jnp().fft.irfft(v, n=n, axis=a),
        "rfft*H+irfft": lambda v, a: _jnp().fft.irfft(
            _along(hm, v.ndim, a) * _jnp().fft.rfft(v, axis=a), n=n,
            axis=a),
        "fft*H+ifft": lambda v, a: _jnp().fft.ifft(
            _along(hc, v.ndim, a) * _jnp().fft.fft(v, axis=a), axis=a),
    }
    return fams, cufft


def _jnp():
    import jax.numpy as jnp

    return jnp


def phase1(rep, shape=(16, 1024, 1024), axes=(1, 2), reps=5):
    import jax

    from ndrustfft_tpu.config import config, precision_override

    n = shape[-1]
    assert all(shape[a] == n for a in axes), shape
    rng = np.random.default_rng(0)
    fams, cufft = _families(n, rng)
    shipped = config.matmul_precision
    other = "high" if shipped == "highest" else "highest"
    xr = rng.standard_normal(shape).astype(np.float32)
    xc = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    dev = {"r": jax.device_put(xr), "c": jax.device_put(xc)}
    cufft_ms = {}
    for a in axes:
        sshape = list(shape)
        sshape[a] = n // 2 + 1
        xs = (rng.standard_normal(sshape)
              + 1j * rng.standard_normal(sshape)).astype(np.complex64)
        dev["s"] = jax.device_put(xs)
        host64 = {"r": xr.astype(np.float64), "c": xc.astype(np.complex128),
                  "s": xs.astype(np.complex128)}
        for name, kind, call, ref_fn, op in fams:
            ref = ref_fn(host64[kind], a)
            errs, times = {}, {}
            for prec in (shipped, other):
                with precision_override(prec):
                    fn = jax.jit(lambda v, _c=call: _c(v, a))
                    errs[prec] = max_rel_err(_run(fn, dev[kind]), ref)
                times[prec] = _ms(fn, dev[kind], reps=reps)
            if (op, a) not in cufft_ms:
                fn = jax.jit(lambda v, _o=cufft[op]: _o(v, a))
                cufft_ms[(op, a)] = _ms(fn, dev[kind], reps=reps)
            print(f"phase1 {name} axis={a} {shape}: err[{shipped}]="
                  f"{errs[shipped]:.3e} err[{other}]={errs[other]:.3e} "
                  f"t[{shipped}]={times[shipped]:.3f} ms "
                  f"t[{other}]={times[other]:.3f} ms "
                  f"t[jnp.fft {op}]={cufft_ms[(op, a)]:.3f} ms", flush=True)
            rep.check(f"phase1 {name} axis={a}", errs[shipped], F32_TOL)
            del ref


# --------------------------------------------------------------------------
# phase 2: awkward sizes
# --------------------------------------------------------------------------


def phase2(rep, prime=1021, prime_batch=16, odd=((129, 1024), (1025, 16)),
           long_log2=20, long_batch=16):
    import jax
    import scipy.fft as sf

    import ndrustfft_tpu as nd

    rng = np.random.default_rng(2)
    shape = (prime_batch, prime, prime)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    xd = jax.device_put(x)
    for a in (1, 2):
        got = _run(jax.jit(lambda v: nd.ndfft(v, axis=a)), xd)
        rep.check(f"phase2 ndfft prime n={prime} axis={a}",
                  max_rel_err(got, sf.fft(x.astype(np.complex128), axis=a,
                                          workers=-1)), F32_TOL)
    del xd, got
    for n, batch in odd:
        xo = rng.standard_normal((batch, n, n)).astype(np.float32)
        xod = jax.device_put(xo)
        for t in (1, 2, 3, 4):
            fn = jax.jit(lambda v, _t=t: getattr(nd, f"nddct{_t}")(v,
                                                                   axis=1))
            rep.check(f"phase2 nddct{t} odd n={n} axis=1",
                      max_rel_err(_run(fn, xod),
                                  sf.dct(xo.astype(np.float64), type=t,
                                         axis=1, workers=-1)), F32_TOL)
        del xod
    n = 1 << long_log2
    xl = (rng.standard_normal((long_batch, n))
          + 1j * rng.standard_normal((long_batch, n))).astype(np.complex64)
    xld = jax.device_put(xl)
    x64 = xl.astype(np.complex128)
    rep.check(f"phase2 ndfft long n=2^{long_log2}",
              max_rel_err(_run(jax.jit(lambda v: nd.ndfft(v, axis=1)), xld),
                          sf.fft(x64, axis=1, workers=-1)), F32_TOL)
    rep.check(f"phase2 ndifft long n=2^{long_log2}",
              max_rel_err(_run(jax.jit(lambda v: nd.ndifft(v, axis=1)), xld),
                          sf.ifft(x64, axis=1, workers=-1)), F32_TOL)


# --------------------------------------------------------------------------
# phase 3: a 3-D spectral step at deployment size
# --------------------------------------------------------------------------


def phase3(rep, edge=512, reps=3):
    import jax

    import __graft_entry__
    import ndrustfft_tpu as nd
    from ndrustfft_tpu.utils.poisson import make_poisson_case

    u, f, g = make_poisson_case((edge,) * 3, (1, 2, 3))
    fd = jax.device_put(f.astype(np.float32))
    gd = jax.device_put(g.astype(np.float32))
    del f, g

    @jax.jit
    def solve(src, greens):
        return nd.irfftn(greens * nd.rfftn(src), n_last=edge)

    got = _run(solve, fd, gd)
    t = _ms(solve, fd, gd, reps=reps)
    print(f"phase3 poisson {edge}^3 f32 rfftn*G+irfftn: {t:.3f} ms",
          flush=True)
    rep.check(f"phase3 poisson {edge}^3 vs analytic", max_rel_err(got, u),
              F32_TOL)
    del got, fd, gd
    step, args = __graft_entry__.entry()
    back = _run(jax.jit(step), *args)
    rep.check("phase3 __graft_entry__.entry() rfft2 roundtrip",
              max_rel_err(back, np.asarray(args[0], np.float64)), F32_TOL)


# --------------------------------------------------------------------------
# phase 4: native float64
# --------------------------------------------------------------------------


def phase4(rep, shape=(4, 1024, 1024)):
    import jax
    import scipy.fft as sf

    import ndrustfft_tpu as nd

    rng = np.random.default_rng(4)
    xc = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    xr = rng.standard_normal(shape)
    xcd = jax.device_put(xc)
    for name, call, ref in (
            ("ndfft", nd.ndfft, lambda v: sf.fft(v, axis=1, workers=-1)),
            ("ndifft", nd.ndifft, lambda v: sf.ifft(v, axis=1, workers=-1))):
        got = _run(jax.jit(lambda v, _c=call: _c(v, axis=1)), xcd)
        assert got.dtype == np.complex128, got.dtype
        rep.check(f"phase4 {name} c128 axis=1", max_rel_err(got, ref(xc)),
                  F64_TOL)
    got = _run(jax.jit(lambda v: nd.nddct2(v, axis=1)), jax.device_put(xr))
    assert got.dtype == np.float64, got.dtype
    rep.check("phase4 nddct2 f64 axis=1",
              max_rel_err(got, sf.dct(xr, type=2, axis=1, workers=-1)),
              F64_TOL)


# --------------------------------------------------------------------------
# --four: the pencil layer across four cards
# --------------------------------------------------------------------------


def _hlo_instructions(hlo):
    """{computation: [(name, opcode, operand names, text)]} of HLO text."""
    comps, cur = {}, None
    head = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
    inst = re.compile(r"^\s+(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*.*?"
                      r"\s([a-z][a-z0-9\-]*)\(([^)]*)\)")
    for ln in hlo.splitlines():
        if not ln.startswith(" ") and ln.rstrip().endswith("{"):
            m = head.match(ln)
            cur = m.group(1) if m else None
            comps[cur] = []
        elif cur is not None and (m := inst.match(ln)):
            ops = re.findall(r"%?([\w.\-]+)", m.group(3))
            comps[cur].append((m.group(1), m.group(2), ops, ln))
    return comps


def a2a_overlap(hlo):
    """(async all-to-all starts, compute ops scheduled inside an open
    all-to-all window) in a scheduled HLO module.

    Async all-to-all appears either as ``all-to-all-start``/``-done`` or as
    ``async-start``/``async-done`` around a computation that holds the
    ``all-to-all``; compute is a ``fusion`` or a library ``custom-call``
    (the matmuls)."""
    comps = _hlo_instructions(hlo)
    holds_a2a = {c for c, ins in comps.items()
                 if any(op == "all-to-all" for _, op, _, _ in ins)}
    starts = overlapped = 0
    for ins in comps.values():
        open_ = set()
        for name, op, operands, text in ins:
            called = re.search(r"calls=%?([\w.\-]+)", text)
            if op == "all-to-all-start" or (
                    op == "async-start" and called
                    and called.group(1) in holds_a2a):
                open_.add(name)
                starts += 1
            elif op in ("all-to-all-done", "async-done"):
                open_.difference_update(operands)
            elif op in ("fusion", "custom-call") and open_:
                overlapped += 1
    return starts, overlapped


def _pencil_overlap(rep, devices, edge):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from ndrustfft_tpu import FftHandler
    from ndrustfft_tpu.parallel import Step, pencil_transform

    mesh = Mesh(np.array(devices[:4]).reshape(2, 2), ("y", "z"))
    steps = [Step("fft", a, FftHandler(edge)) for a in (2, 1, 0)]
    xs = jax.ShapeDtypeStruct((edge,) * 3, jnp.complex64,
                              sharding=NamedSharding(mesh, P("y", "z", None)))
    hlo = jax.jit(lambda v: pencil_transform(
        v, steps, mesh, P("y", "z", None), pipeline_chunks=2)[0]).lower(
            xs).compile().as_text()
    starts, inside = a2a_overlap(hlo)
    print(f"four: pipeline_chunks=2 HLO: {starts} async all-to-all starts, "
          f"{inside} compute ops inside an open window", flush=True)
    ok = starts >= 4 and inside >= 1
    if not ok:
        for line in [ln for ln in hlo.splitlines() if "all-to-all" in ln][:40]:
            print("  hlo: " + line.strip(), flush=True)
    rep.check("four: all-to-all start -> compute -> done in the HLO",
              0.0 if ok else float("inf"), 0.0)


def phase_four(rep, devices, edge=512, par_shape=(64, 1024, 1024),
               hlo_edge=256, check_overlap=True):
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    import ndrustfft_tpu as nd
    from ndrustfft_tpu.parallel import (
        irfftn_pencil, rfftn_pencil, spectral_pencil,
    )
    from ndrustfft_tpu.utils.poisson import make_poisson_case

    rng = np.random.default_rng(5)
    x = rng.standard_normal((edge,) * 3).astype(np.float32)
    ref = np.asarray(_run(jax.jit(nd.rfftn), jax.device_put(x, devices[0])))
    spec = P("y", "z", None)
    u, f, g = make_poisson_case((edge,) * 3, (1, 2, 3))
    for mshape in ((1, 4), (2, 2)):
        mesh = Mesh(np.array(devices[:4]).reshape(mshape), ("y", "z"))
        xd = jax.device_put(x, NamedSharding(mesh, spec))
        tag = f"four {mshape[0]}x{mshape[1]} {edge}^3"
        for wire in (None, "bfloat16x2", "int16"):
            out_spec = {}

            def fwd(v, _m=mesh, _w=wire):
                vhat, s = rfftn_pencil(v, _m, spec, wire_dtype=_w)
                out_spec["s"] = s
                return vhat

            vhat = _run(jax.jit(fwd), xd)
            e_spec = max_rel_err(vhat, ref)
            back = _run(jax.jit(lambda v, _m=mesh, _w=wire: irfftn_pencil(
                v, _m, out_spec["s"], n_last=edge, axes=[0, 1, 2],
                wire_dtype=_w)[0]), vhat)
            e_rt = float(np.max(np.abs(np.asarray(back) - x)))
            print(f"{tag} wire={wire}: spectrum vs single-card rfftn "
                  f"max-rel {e_spec:.3e}, roundtrip max-abs {e_rt:.3e}",
                  flush=True)
            if wire is None:
                rep.check(f"{tag} rfftn_pencil vs single-card rfftn",
                          e_spec, F32_TOL)
            rep.check(f"{tag} wire={wire} roundtrip (abs)", e_rt,
                      WIRE_TOL[wire])
            del vhat, back
        fs = jax.device_put(f.astype(np.float32), NamedSharding(mesh, spec))
        got = _run(jax.jit(lambda v, gr, _m=mesh: spectral_pencil(
            v, gr, _m, spec)[0]), fs, g.astype(np.float32))
        rep.check(f"{tag} spectral_pencil Poisson vs analytic",
                  max_rel_err(got, u), F32_TOL)
        del xd, fs, got
    # the SPMD path: ndfft_par traced inside jit on a sharded input
    xc = (rng.standard_normal(par_shape)
          + 1j * rng.standard_normal(par_shape)).astype(np.complex64)
    serial = np.asarray(_run(jax.jit(lambda v: nd.ndfft(v, axis=1)),
                             jax.device_put(xc, devices[0])))
    mesh1 = Mesh(np.array(devices[:4]), ("d",))
    par = jax.jit(lambda v: nd.ndfft_par(v, axis=1))
    xs = jax.device_put(xc, NamedSharding(mesh1, P(None, "d", None)))
    hlo = par.lower(xs).compile().as_text()
    n_a2a = sum("all-to-all" in ln for ln in hlo.splitlines()
                if "= " in ln)
    n_ag = sum("all-gather" in ln for ln in hlo.splitlines() if "= " in ln)
    print(f"four: ndfft_par under jit: {n_a2a} all-to-all and {n_ag} "
          f"all-gather instructions", flush=True)
    rep.check("four ndfft_par (SPMD) vs serial ndfft",
              max_rel_err(_run(par, xs), serial), F32_TOL)
    rep.check("four ndfft_par lowers to all-to-all, no all-gather",
              0.0 if n_a2a >= 1 and n_ag == 0 else float("inf"), 0.0)
    if check_overlap:
        _pencil_overlap(rep, devices, hlo_edge)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the pencil/SPMD path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    count = 4 if args.four else 1
    t0 = time.perf_counter()
    device = phase0(count)
    rep = Report()
    if args.four:
        phases = [lambda: phase_four(rep, jax.devices())]
    else:
        phases = [lambda: phase1(rep), lambda: phase2(rep),
                  lambda: phase3(rep), lambda: phase4(rep)]
    for i, run in enumerate(phases):
        t = time.perf_counter()
        run()
        print(f"phase {'four' if args.four else i + 1} done in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if rep.failures:
        print("FAILED checks:\n  " + "\n  ".join(rep.failures),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
