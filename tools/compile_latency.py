"""Cold/warm compile-latency measurement — the serving recipe, with numbers.

A serving deployment must know (a) what a cold first call costs per
transform family and (b) how much `utils.cache.enable_persistent_cache` +
`handler.warmup()` recover on restart.

Protocol: the same worker program runs in THREE fresh subprocesses, one
after the other (so only one of them holds the device at a time) —

  1. cold      — no persistent cache: full trace + compile
  2. seed      — persistent cache enabled, empty dir: pays cold cost once
                 and writes the cache entries
  3. warm      — persistent cache enabled, seeded dir: first call hits the
                 on-disk XLA cache (trace + deserialize only)

Each worker times `handler.warmup(shape)` per family (the documented
serving recipe: one blocking call that compiles forward AND inverse and
populates the jit dispatch cache) and prints one JSON line; the parent
aggregates a cold/warm table. The seeded cache lives in the fixed
directory ``<repo>/.jax_cache/compile_latency``, emptied at the start.
Times are device numbers only when the workers ran on the GPU.

Usage: python tools/compile_latency.py [--n 1024] [--cols 256]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_REPO, ".jax_cache", "compile_latency")


def _worker(n: int, cols: int, use_cache: bool):
    import time

    sys.path.insert(0, _REPO)
    if use_cache:
        from ndrustfft_tpu.utils.cache import enable_persistent_cache

        enable_persistent_cache(min_compile_seconds=0.0)

    from ndrustfft_tpu import DctHandler, FftHandler, R2cFftHandler

    shape = (2, n, cols)
    out = {}
    for fam, h in (("c2c", FftHandler(n)),
                   ("r2c", R2cFftHandler(n)),
                   ("dct", DctHandler(n))):
        t0 = time.perf_counter()
        h.warmup(shape, axis=1)
        out[fam] = round(time.perf_counter() - t0, 2)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--cols", type=int, default=256)
    ap.add_argument("--worker-cache", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _worker(args.n, args.cols, args.worker_cache)
        return

    shutil.rmtree(_CACHE, ignore_errors=True)

    def run_leg(name, use_cache):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--n", str(args.n), "--cols", str(args.cols)]
        env = dict(os.environ)
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        if use_cache:
            cmd.append("--worker-cache")
            env["JAX_COMPILATION_CACHE_DIR"] = _CACHE
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600,
                           cwd=_REPO, env=env)
        if r.returncode != 0:
            raise RuntimeError(f"leg {name} failed:\n{r.stderr[-2000:]}")
        times = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"leg": name, "warmup_seconds": times}), flush=True)
        return times

    cold = run_leg("cold_no_cache", False)
    seed = run_leg("cold_seed_cache", True)
    warm = run_leg("warm_from_cache", True)
    speedup = {k: round(cold[k] / max(warm[k], 1e-9), 1) for k in cold}
    print(json.dumps({"leg": "summary", "cold": cold, "seed": seed,
                      "warm": warm, "cold_over_warm": speedup}), flush=True)


if __name__ == "__main__":
    main()
