"""Measured CPU f64 wall-times at the reference's criterion shapes.

The reference's native domain is f64 on CPU (criterion benches
/root/reference/benches/ndrustfft.rs:6-60: fft2d / rfft2d / dct2d on n x n
arrays, transform along axis 0, single array per call). The reference
publishes no numbers, so this records OUR library's CPU-backend f64
wall-times at those exact shapes — the survey's "first measurement action"
(SURVEY.md §6), closed in round 5 (verdict next #7).

Each row is a plain median-of-reps of one jitted call on a committed
device array, ending in ``block_until_ready``. numpy's pocketfft timing is
reported alongside as the local stand-in baseline (the reference's rustfft
CPU backend cannot run here: no Rust toolchain, zero egress).

Usage: python tools/cpu_f64_grid.py  (prints one JSON line per row)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.fft  # noqa: E402

from ndrustfft_tpu import (  # noqa: E402
    DctHandler, FftHandler, R2cFftHandler, nddct1, ndfft, ndfft_r2c,
)


def _median_time(fn, reps=9):
    fn()  # warm/compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _bench_jax(step, x):
    xj = jnp.asarray(x)
    f = jax.jit(step)
    return _median_time(lambda: f(xj).block_until_ready())


def main():
    rng = np.random.default_rng(0)
    rows = []

    for n in (128, 264, 512, 1024):
        # fft2d: C2C f64 (complex128), n x n, axis 0
        xc = (rng.standard_normal((n, n))
              + 1j * rng.standard_normal((n, n)))
        h = FftHandler(n)
        t = _bench_jax(lambda v, _h=h: ndfft(v, _h, axis=0), xc)
        t_np = _median_time(lambda: np.fft.fft(xc, axis=0))
        rows.append({"metric": f"cpu_f64_fft2d_{n}_axis0",
                     "value": round(t * 1e6, 1), "unit": "us/call",
                     "numpy_us": round(t_np * 1e6, 1),
                     "vs_numpy": round(t_np / t, 2)})

        # rfft2d: R2C f64, n x n, axis 0
        xr = rng.standard_normal((n, n))
        hr = R2cFftHandler(n)
        t = _bench_jax(lambda v, _h=hr: ndfft_r2c(v, _h, axis=0), xr)
        t_np = _median_time(lambda: np.fft.rfft(xr, axis=0))
        rows.append({"metric": f"cpu_f64_rfft2d_{n}_axis0",
                     "value": round(t * 1e6, 1), "unit": "us/call",
                     "numpy_us": round(t_np * 1e6, 1),
                     "vs_numpy": round(t_np / t, 2)})

    for d in (129, 265, 513, 1025):
        # dct2d: DCT-I f64 (the reference's dct2d group benches DCT-I)
        xd = rng.standard_normal((d, d))
        hd = DctHandler(d)
        t = _bench_jax(lambda v, _h=hd: nddct1(v, _h, axis=0), xd)
        t_sp = _median_time(lambda: scipy.fft.dct(xd, type=1, axis=0))
        rows.append({"metric": f"cpu_f64_dct2d_1_{d}_axis0",
                     "value": round(t * 1e6, 1), "unit": "us/call",
                     "scipy_us": round(t_sp * 1e6, 1),
                     "vs_scipy": round(t_sp / t, 2)})

    for r in rows:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
