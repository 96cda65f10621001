"""Fused spectral filtering with ndspectral_r2c — the r2c -> diagonal
multiply -> c2r pipeline compiled as one program.

Three canonical frequency-domain operators on a batch of real signals,
each ONE call:

  1. sharp low-pass (dealiasing-style 2/3 truncation),
  2. spectral first derivative (multiplier i*k),
  3. 1-D periodic Poisson solve (multiplier -1/k^2, zero-mean gauge).

The reference has no fused analog (each transform is a separate call,
src/lib.rs:169-238); semantics are pinned against the explicit
ndifft_r2c(mult * ndfft_r2c(x)) composition and numpy oracles.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from ndrustfft_tpu import R2cFftHandler, ndfft_r2c, ndifft_r2c, ndspectral_r2c


def main():
    n = 256
    h = R2cFftHandler(n)
    k = np.fft.rfftfreq(n, d=1.0 / n)          # integer wavenumbers 0..n/2
    t = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    # two tones + "noise" above the cutoff
    rng = np.random.default_rng(0)
    x = (np.sin(3 * t) + 0.5 * np.cos(7 * t)
         + 0.1 * rng.standard_normal(n) * 0.0
         + 0.2 * np.sin(100 * t))
    xb = jnp.asarray(np.broadcast_to(x, (4, n)).copy())

    # 1. sharp low-pass at the 2/3 rule
    keep = jnp.asarray((k <= n // 3).astype(np.float64))
    y = ndspectral_r2c(xb, keep, h, axis=1)
    ref = ndifft_r2c(keep[None, :] * ndfft_r2c(xb, h, axis=1), h, axis=1)
    assert float(jnp.abs(y - ref).max()) < 1e-12
    # the 100-mode is gone, the low tones survive
    lowpass_oracle = np.sin(3 * t) + 0.5 * np.cos(7 * t)
    assert float(jnp.abs(y[0] - lowpass_oracle).max()) < 1e-10
    print("low-pass:   max|y - oracle| =",
          float(jnp.abs(y[0] - lowpass_oracle).max()))

    # 2. spectral derivative: d/dt sin(3t) = 3 cos(3t)
    ik = jnp.asarray(1j * k)
    xs = jnp.asarray(np.broadcast_to(np.sin(3 * t), (4, n)).copy())
    dx = ndspectral_r2c(xs, ik, h, axis=1)
    d_oracle = 3.0 * np.cos(3 * t)
    assert float(jnp.abs(dx[0] - d_oracle).max()) < 1e-9
    print("derivative: max|dx - 3cos(3t)| =",
          float(jnp.abs(dx[0] - d_oracle).max()))

    # 3. periodic Poisson u'' = f with f = -9 sin(3t): u = sin(3t)
    f = jnp.asarray(np.broadcast_to(-9.0 * np.sin(3 * t), (4, n)).copy())
    inv_k2 = np.zeros_like(k)
    inv_k2[1:] = -1.0 / k[1:] ** 2              # zero-mean gauge at k=0
    u = ndspectral_r2c(f, jnp.asarray(inv_k2), h, axis=1)
    u_oracle = np.sin(3 * t)
    assert float(jnp.abs(u[0] - u_oracle).max()) < 1e-9
    print("poisson:    max|u - sin(3t)| =",
          float(jnp.abs(u[0] - u_oracle).max()))

    # 4. Neumann Poisson via the fused DCT pipeline (ndspectral_dct):
    #    -u'' = f on [0, pi] with u'(0) = u'(pi) = 0; cosine basis
    #    diagonalizes it: u_hat[k] = f_hat[k] / k^2 (zero-mean gauge).
    from ndrustfft_tpu import DctHandler, Normalization, ndspectral_dct

    nn = 128
    tc = (np.arange(nn) + 0.5) * np.pi / nn      # DCT-II sample points
    fsrc = 9.0 * np.cos(3 * tc)                  # f = -u'' for u = cos(3t)
    fb = jnp.asarray(np.broadcast_to(fsrc, (4, nn)).copy())
    lam = np.zeros(nn)
    lam[1:] = 1.0 / np.arange(1, nn) ** 2        # 1/k^2, zero-mean gauge
    h2 = DctHandler(nn).normalization(Normalization.NONE)
    h3 = DctHandler(nn).normalization(Normalization.scalar(2.0 / nn))
    u = ndspectral_dct(fb, jnp.asarray(lam), h2, h3, axis=1)
    u_oracle = np.cos(3 * tc)
    assert float(jnp.abs(u[0] - u_oracle).max()) < 1e-9
    print("neumann:    max|u - cos(3t)| =",
          float(jnp.abs(u[0] - u_oracle).max()))

    # 5. 2-D periodic Poisson with a LANE-VARYING multiplier: the full
    #    solve is ifft0(irfft1(G * fft0(rfft1(v)))) — five transform
    #    passes. The middle three (fft0, full-field multiply, ifft0)
    #    collapse into ONE fused call because G varies along the c2c
    #    transform axis AND the trailing spectrum axis: exactly the
    #    (n,) + trailing lane-varying fast path. 5 passes -> 3.
    from ndrustfft_tpu import FftHandler, ndspectral_c2c

    ny, nx = 64, 128
    ty = np.linspace(0, 2 * np.pi, ny, endpoint=False)
    tx = np.linspace(0, 2 * np.pi, nx, endpoint=False)
    u_true = np.sin(3 * ty)[:, None] * np.cos(5 * tx)[None, :]
    fsrc2 = (3**2 + 5**2) * u_true               # f = -lap u
    ky = np.fft.fftfreq(ny, 1.0 / ny)
    kx = np.fft.rfftfreq(nx, 1.0 / nx)
    k2 = ky[:, None] ** 2 + kx[None, :] ** 2
    G = np.zeros((ny, kx.size))
    G[k2 > 0] = 1.0 / k2[k2 > 0]                 # zero-mean gauge
    hy = FftHandler(ny)
    hx = R2cFftHandler(nx)
    w = ndfft_r2c(jnp.asarray(fsrc2), hx, axis=1)        # (ny, m)
    w = ndspectral_c2c(w, jnp.asarray(G + 0j), hy, axis=0)
    u2 = ndifft_r2c(w, hx, axis=1)
    assert float(jnp.abs(u2 - u_true).max()) < 1e-9
    print("poisson2d:  max|u - oracle| =",
          float(jnp.abs(u2 - u_true).max()))

    print("fused_filter: all oracles passed — OK")


if __name__ == "__main__":
    main()
