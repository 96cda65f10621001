"""Benchmark harness — prints JSON lines (headline line last).

Protocol mirrors the reference's criterion benches (benches/ndrustfft.rs:
fft2d / rfft2d / dct2d on n x n arrays, transform along axis 0 of each
slice) on a batch of slices, as GFLOP/s (5*N*log2(N) convention) and as a
share of the device-memory roofline from the device table in
``ndrustfft_tpu.utils.profiling``.

Measurement: each row jits ONE public call over the whole batch, runs it
once to compile, then reports the median wall time of ``reps`` calls that
each end in ``block_until_ready``, divided by the number of transforms the
call performs. Every row names the device it ran on. A row whose
measurement raises fails the run; there is no fallback to another device.

``vs_baseline`` compares the headline against XLA's built-in FFT
(``jnp.fft``, cuFFT on the GPU) computing the same values on the same
card, measured in alternating rounds. The headline computes
``v <- ifft_unnorm(v) * c`` with c = 1.001/sqrt(n): ours as ONE public
call with the scalar folded into the transform
(``ndifft(v, handler.normalization(Normalization.scalar(c)))``), the
baseline as ``jnp.fft.ifft(v) * (c * n)``.

Which cells define the benchmark, and their limits, is ROADMAP S1's job.

Usage: python bench.py [--all] [--only SUBSTR,...] [--verify]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time


def _device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py measures the GPU; JAX found "
                           f"{dev.platform!r} ({dev.device_kind})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def _median_s(fn, x, reps=7):
    """Median seconds of one ``fn(x)`` call, compile excluded."""
    import jax

    jax.block_until_ready(fn(x))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def per_transform(step, x, transforms):
    """Seconds per transform of the jitted ``step`` applied to ``x``, which
    performs ``transforms`` transforms per call."""
    import jax

    return _median_s(jax.jit(step), x) / transforms


def compare(step_a, step_b, x, transforms, rounds=7):
    """Alternating A/B rounds: per-round per-transform times of each and
    the per-round ratios t_b / t_a."""
    import jax

    fa, fb = jax.jit(step_a), jax.jit(step_b)
    tas, tbs = [], []
    for _ in range(rounds):
        tas.append(_median_s(fa, x, reps=3) / transforms)
        tbs.append(_median_s(fb, x, reps=3) / transforms)
    return tas, tbs, [b / a for a, b in zip(tas, tbs)]


def verify(n=1024, cols=256, primes=(509, 1021), long_n=1 << 18):
    """On-device numeric check of every family against host float64
    references: one JSON line with the max-rel error of each. Transforms
    run along axis 1 of (2, size, cols) arrays; the odd DCT size is
    ``n // 2 + 1`` and the long 1-D transform has ``long_n`` points."""
    import jax
    import numpy as np
    import scipy.fft as sf

    from ndrustfft_tpu import (
        DstHandler, FftHandler, R2cFftHandler, nddct2, nddct3, nddst2,
        nddst3, ndfft, ndfft_r2c, ndifft, ndifft_r2c, ndspectral_c2c,
        ndspectral_dct, ndspectral_r2c,
    )
    from ndrustfft_tpu.config import config

    rng = np.random.default_rng(0)
    errs = {}

    def run_case(name, fn, x, ref):
        got = np.asarray(jax.jit(fn)(jax.device_put(x)))
        errs[name] = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))

    def cplx(shape, dtype=np.complex64):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dtype)

    x = cplx((2, n, cols))
    x64 = x.astype(np.complex128)
    h = FftHandler(n)
    run_case(f"c2c_{n}", lambda v: ndfft(v, h, axis=1), x,
             sf.fft(x64, axis=1))
    run_case(f"c2c_roundtrip_{n}",
             lambda v: ndifft(ndfft(v, h, axis=1), h, axis=1), x, x64)
    for p in primes:   # Bluestein
        xp = cplx((2, p, cols))
        run_case(f"c2c_blue_{p}", lambda v: ndfft(v, axis=1), xp,
                 sf.fft(xp.astype(np.complex128), axis=1))
    xr = rng.standard_normal((2, n, cols)).astype(np.float32)
    xr64 = xr.astype(np.float64)
    hr = R2cFftHandler(n)
    run_case(f"r2c_{n}", lambda v: ndfft_r2c(v, hr, axis=1), xr,
             sf.rfft(xr64, axis=1))
    run_case(f"r2c_c2r_{n}",
             lambda v: ndifft_r2c(ndfft_r2c(v, hr, axis=1), hr, axis=1), xr,
             xr64)
    for d in (n, n // 2 + 1):
        xd = rng.standard_normal((2, d, cols)).astype(np.float32)
        xd64 = xd.astype(np.float64)
        run_case(f"dct2_{d}", lambda v: nddct2(v, axis=1), xd,
                 sf.dct(xd64, type=2, axis=1))
        run_case(f"dct3_{d}", lambda v: nddct3(v, axis=1), xd,
                 sf.dct(xd64, type=3, axis=1))
    hs = DstHandler(n)
    run_case(f"dst2_{n}", lambda v: nddst2(v, hs, axis=1), xr,
             sf.dst(xr64, type=2, axis=1))
    run_case(f"dst3_{n}", lambda v: nddst3(v, hs, axis=1), xr,
             sf.dst(xr64, type=3, axis=1))
    xl = cplx((2, long_n))
    run_case(f"c2c_long_{long_n}", lambda v: ndfft(v, axis=1), xl,
             sf.fft(xl.astype(np.complex128), axis=1))
    ones_m = np.ones(n // 2 + 1, np.float32)
    run_case(f"spectral_r2c_{n}",
             lambda v: ndspectral_r2c(v, ones_m, hr, axis=1), xr, xr64)
    ones_n = np.ones(n, np.float32)
    run_case(f"spectral_c2c_{n}",
             lambda v: ndspectral_c2c(v, ones_n, h, axis=1), x, x64)
    run_case(f"spectral_dct_{n}",
             lambda v: ndspectral_dct(v, ones_n, axis=1), xr,
             sf.dct(sf.dct(xr64, type=2, axis=1), type=3, axis=1))
    # native float64
    xf = cplx((2, n, cols // 4), np.complex128)
    run_case(f"f64_c2c_{n}", lambda v: ndfft(v, axis=1), xf,
             sf.fft(xf, axis=1))
    ok = all(v < (1e-10 if k.startswith("f64") else 1e-5)
             for k, v in errs.items())
    print(json.dumps({
        "metric": "family_verify", "pass": ok, "device": _device(),
        "precision": config.matmul_precision, "max_rel_errors": errs,
    }))
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true",
                    help="run the full criterion-style grid")
    ap.add_argument("--verify", action="store_true",
                    help="on-device numeric check; one JSON verdict line")
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated substrings: with --all, measure "
                         "only grid rows whose metric name matches, and "
                         "skip the headline")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=16,
                    help="n x n slices per call (16 x 1024^2 c64 = 128 MB)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    device = _device()
    from ndrustfft_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if args.verify:
        return verify()

    import jax.numpy as jnp
    import numpy as np

    from ndrustfft_tpu import FftHandler, Normalization, ndfft, ndifft
    from ndrustfft_tpu.utils.profiling import chip_spec

    hbm = chip_spec().hbm_gbps
    n, B = args.n, args.batch
    rng = np.random.default_rng(0)
    only = [s for s in args.only.split(",") if s]
    skip_headline = bool(args.all and only)

    def cplx(shape):
        return jax.device_put((rng.standard_normal(shape) + 1j
                               * rng.standard_normal(shape)
                               ).astype(np.complex64))

    def real(shape):
        return jax.device_put(rng.standard_normal(shape).astype(np.float32))

    def rates(m, t, itemsize, flop_share=1.0):
        return {"gflops": round(flop_share * 5.0 * m * math.log2(m) * m
                                / t / 1e9, 1),
                "pct_hbm_roofline": round(
                    100 * 2 * m * m * itemsize / (hbm * 1e9) / t, 1)}

    def emit(metric, t, extra=None):
        row = {"metric": metric, "unit": "us/transform",
               "value": round(t * 1e6, 2), "device": device}
        row.update(extra or {})
        print(json.dumps(row), flush=True)

    def want(metric):
        return not only or any(s in metric for s in only)

    drift = 1.001
    if args.all:
        from ndrustfft_tpu import (
            DctHandler, DstHandler, R2cFftHandler, nddct1, nddct2, nddct3,
            nddct4, nddst2, nddst3, ndfft_r2c, ndifft_par, ndifft_r2c,
            ndspectral_c2c, ndspectral_dct, ndspectral_r2c,
        )

        def batch_for(m, itemsize):
            return max(1, (1 << 27) // (m * m * itemsize))

        for m in [128, 264, 512, 1024, 2048]:
            if want(f"fft2d_{m}_"):
                bm = batch_for(m, 8)
                hm = FftHandler(m).normalization(
                    Normalization.scalar(drift / math.sqrt(m)))
                t = per_transform(lambda v, _h=hm: ndifft(v, _h, axis=1),
                                  cplx((bm, m, m)), bm)
                emit(f"fft2d_{m}_c2c_f32_axis0", t, rates(m, t, 8))
        for m in [128, 264, 512, 1024]:
            bm = batch_for(m, 4)
            if want(f"rfft2d_{m}_"):
                hr = R2cFftHandler(m)
                hri = R2cFftHandler(m).normalization(
                    Normalization.scalar(drift / m))
                t = per_transform(
                    lambda v, _h=hr, _hi=hri: ndifft_r2c(
                        ndfft_r2c(v, _h, axis=1), _hi, axis=1),
                    real((bm, m, m)), 2 * bm)
                emit(f"rfft2d_{m}_f32_axis0", t, rates(m, t, 4, 0.5))
            for d in (m + 1, m):
                bd = batch_for(d, 4)
                if want(f"dct2d_23_{d}_"):
                    h2 = DctHandler(d).normalization(Normalization.NONE)
                    h3 = DctHandler(d).normalization(
                        Normalization.scalar(2.0 * drift / d))
                    t = per_transform(
                        lambda v, _h2=h2, _h3=h3: nddct3(
                            nddct2(v, _h2, axis=1), _h3, axis=1),
                        real((bd, d, d)), 2 * bd)
                    emit(f"dct2d_23_{d}_f32_axis0", t, rates(d, t, 4, 0.5))
            d = m + 1
            if want(f"dct2d_1_{d}_"):
                # DCT-I is self-inverse up to 2(n-1) in this convention
                h1a = DctHandler(d).normalization(Normalization.NONE)
                h1b = DctHandler(d).normalization(
                    Normalization.scalar(4.0 * drift / (2.0 * (d - 1))))
                t = per_transform(
                    lambda v, _a=h1a, _b=h1b: nddct1(
                        nddct1(v, _a, axis=1), _b, axis=1),
                    real((batch_for(d, 4), d, d)), 2 * batch_for(d, 4))
                emit(f"dct2d_1_{d}_f32_axis0", t)

        for m in [509, 1021]:   # Bluestein primes
            if want(f"fft2d_prime_{m}_"):
                bm = batch_for(m, 8)
                hm = FftHandler(m).normalization(
                    Normalization.scalar(drift / math.sqrt(m)))
                t = per_transform(lambda v, _h=hm: ndifft(v, _h, axis=1),
                                  cplx((bm, m, m)), bm)
                emit(f"fft2d_prime_{m}_c2c_f32_axis0", t, rates(m, t, 8))

        for ln in [1 << 18, 1 << 20]:
            if want(f"fft1d_long_{ln}_"):
                bm = max(2, (1 << 27) // (ln * 8))
                hm = FftHandler(ln).normalization(
                    Normalization.scalar(drift / math.sqrt(ln)))
                t = per_transform(lambda v, _h=hm: ndifft(v, _h, axis=1),
                                  cplx((bm, ln)), bm)
                emit(f"fft1d_long_{ln}_c2c_f32", t, {"gflops": round(
                    5.0 * ln * math.log2(ln) / t / 1e9, 1)})

        d = 2049
        if want(f"dct2d_23_{d}_"):
            bd = batch_for(d, 4)
            h2 = DctHandler(d).normalization(Normalization.NONE)
            h3 = DctHandler(d).normalization(
                Normalization.scalar(2.0 * drift / d))
            t = per_transform(
                lambda v: nddct3(nddct2(v, h2, axis=1), h3, axis=1),
                real((bd, d, d)), 2 * bd)
            emit(f"dct2d_23_{d}_f32_axis0", t)

        if want("dst2d_23_1024_"):
            hs2 = DstHandler(1024).normalization(Normalization.NONE)
            hs3 = DstHandler(1024).normalization(
                Normalization.scalar(2.0 * drift / 1024))
            t = per_transform(
                lambda v: nddst3(nddst2(v, hs2, axis=1), hs3, axis=1),
                real((16, 1024, 1024)), 2 * 16)
            emit("dst2d_23_1024_f32_axis0", t, rates(1024, t, 4, 0.5))

        if want("dct2d_4_2048_"):
            # DCT-IV is an involution: dct4(dct4(x)) = (n/2) x
            h4a = DctHandler(2048).normalization(Normalization.NONE)
            h4b = DctHandler(2048).normalization(
                Normalization.scalar(2.0 * drift / 2048))
            t = per_transform(
                lambda v: nddct4(nddct4(v, h4a, axis=1), h4b, axis=1),
                real((8, 2048, 2048)), 2 * 8)
            emit("dct2d_4_2048_f32_axis0", t)

        # fused spectral steps, identity multiplier: the same math as the
        # pair rows above, compiled as one program
        for ms in [512, 1024]:
            bm = batch_for(ms, 4)
            if want(f"spectral_r2c_{ms}_"):
                hsp = R2cFftHandler(ms).normalization(
                    Normalization.scalar(drift / ms))
                ones = np.ones(ms // 2 + 1, np.float32)
                t = per_transform(
                    lambda v, _h=hsp, _o=ones: ndspectral_r2c(v, _o, _h,
                                                              axis=1),
                    real((bm, ms, ms)), 2 * bm)
                emit(f"spectral_r2c_{ms}_f32_axis0", t,
                     rates(ms, t, 4, 0.5))
            if want(f"spectral_c2c_{ms}_"):
                bc = batch_for(ms, 8)
                hcs = FftHandler(ms).normalization(
                    Normalization.scalar(drift / ms))
                ones = np.ones(ms, np.float32)
                t = per_transform(
                    lambda v, _h=hcs, _o=ones: ndspectral_c2c(v, _o, _h,
                                                              axis=1),
                    cplx((bc, ms, ms)), 2 * bc)
                emit(f"spectral_c2c_{ms}_f32_axis0", t, rates(ms, t, 8))
            if want(f"spectral_dct_{ms}_"):
                hd2 = DctHandler(ms).normalization(Normalization.NONE)
                hd3 = DctHandler(ms).normalization(
                    Normalization.scalar(2.0 * drift / ms))
                ones = np.ones(ms, np.float32)
                t = per_transform(
                    lambda v, _a=hd2, _b=hd3, _o=ones: ndspectral_dct(
                        v, _o, _a, _b, axis=1),
                    real((bm, ms, ms)), 2 * bm)
                emit(f"spectral_dct_{ms}_f32_axis0", t,
                     rates(ms, t, 4, 0.5))

        if want("fft2d_par_1024_"):
            # on one device the _par entry points are the serial ones
            hp = FftHandler(1024).normalization(
                Normalization.scalar(drift / math.sqrt(1024)))
            t = per_transform(lambda v: ndifft_par(v, hp, axis=1),
                              cplx((16, 1024, 1024)), 16)
            emit("fft2d_par_1024_c2c_f32_axis0", t)

    if skip_headline:
        return 0

    c = drift / math.sqrt(n)
    hf = FftHandler(n).normalization(Normalization.scalar(c))
    x = cplx((B, n, n))
    tas, tbs, ratios = compare(lambda v: ndifft(v, hf, axis=1),
                               lambda v: jnp.fft.ifft(v, axis=1) * (c * n),
                               x, B)
    t_med = statistics.median(tas)
    h = FftHandler(n)
    t_unfused = per_transform(
        lambda v: ndfft(v, h, axis=1) * (1.0 / math.sqrt(n)), x, B)
    print(json.dumps({
        "metric": f"fft2d_{n}_c2c_f32_axis0",
        "value": round(5.0 * n * math.log2(n) * n / t_med / 1e9, 2),
        "unit": "GFLOP/s (5NlogN)",
        "vs_baseline": round(statistics.median(ratios), 3),
        "pct_hbm_roofline": round(
            100.0 * 2.0 * n * n * 8 / (hbm * 1e9) / t_med, 1),
        "us_per_transform": {"min": round(min(tas) * 1e6, 2),
                             "median": round(t_med * 1e6, 2),
                             "max": round(max(tas) * 1e6, 2)},
        "jnp_fft_us_per_transform": round(statistics.median(tbs) * 1e6, 2),
        "ratio_spread": [round(min(ratios), 3), round(max(ratios), 3)],
        "unfused_us_per_transform": round(t_unfused * 1e6, 2),
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
