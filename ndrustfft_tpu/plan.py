"""Plan layer: factorization + plan-time twiddle/DFT constants.

The analog of the reference's plan cache: where ``FftHandler`` holds
``Arc<dyn Fft>`` plans built eagerly by rustfft's planner (reference
src/lib.rs:294-304), a :class:`C2CPlan` here is a static *schedule* — a factor
list plus numpy constant tables (base DFT matrices, inter-stage twiddles,
Bluestein chirps) — built once per (n, direction) and closed over by the
traced JAX computation, where they become on-device constants.

Design notes (not a port):
  * The reference delegates to rustfft's mixed-radix/Rader/Bluestein planner
    (SURVEY.md §2.2 N1). Here the FLOPs land in matrix multiplies, so the
    planner factors n into few LARGE factors (each ≤ max_base_radix) and
    lowers each base DFT to a dense matmul — a four-step/six-step FFT — rather
    than many tiny scalar butterflies. Fewer stages also means fewer HBM
    round-trips, which is the real bottleneck.
  * Primes > max_base_radix route through Bluestein (chirp-z), mirroring
    rustfft's "any n" capability.
  * All angle tables are generated with integer modular reduction of the phase
    index before multiplying by pi/n, keeping twiddles accurate to f64 ulp for
    large n (needed for the 1e-12 f64 parity target).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

from .config import config


# --------------------------------------------------------------------------
# Integer factorization / factor grouping
# --------------------------------------------------------------------------


def prime_factors(n: int) -> list[int]:
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        fs.append(n)
    return fs


def _greedy_partition(primes: list[int], k: int, max_base: int) -> Optional[list[int]]:
    """Group prime factors into k buckets of product ≤ max_base, balanced."""
    buckets = [1] * k
    for p in sorted(primes, reverse=True):
        # place into the smallest bucket that still fits
        order = sorted(range(k), key=lambda i: buckets[i])
        for i in order:
            if buckets[i] * p <= max_base:
                buckets[i] *= p
                break
        else:
            return None
    return [b for b in buckets if b > 1] or [1]


def factorize(n: int, max_base: Optional[int] = None) -> Optional[tuple[int, ...]]:
    """Factor n into a few factors each ≤ max_base (largest first).

    Returns None when n has a prime factor > max_base (Bluestein territory).
    Uses the native C++ planner (native/planner.cpp) when built; the Python
    path below is the exact algorithmic twin. The config.max_base_radix
    toggle is resolved BEFORE the cache so runtime changes take effect.
    """
    max_base = max_base or config.max_base_radix
    if max_base < 3:
        # Bluestein pads to a 3-smooth length: max_base < 3 would make every
        # Bluestein sub-plan recurse into Bluestein again, unboundedly
        raise ValueError(
            f"max_base_radix must be >= 3, got {max_base} "
            "(set config.max_base_radix / NDRUSTFFT_TPU_MAX_RADIX)")
    return _factorize(n, max_base)


@lru_cache(maxsize=None)
def _factorize(n: int, max_base: int) -> Optional[tuple[int, ...]]:
    if n <= 0:
        raise ValueError(f"transform length must be positive, got {n}")
    from . import native

    r = native.factorize_native(n, max_base)
    if r is not NotImplemented:
        return r
    if n == 1:
        return (1,)
    pf = prime_factors(n)
    if max(pf) > max_base:
        return None
    k = 1
    while max_base**k < n:
        k += 1
    while True:
        parts = _greedy_partition(pf, k, max_base)
        if parts is not None:
            return tuple(sorted(parts, reverse=True))
        k += 1


def next_smooth(n: int) -> int:
    """Smallest 3-smooth number (2^a * 3^b) ≥ n — Bluestein convolution
    length; 3-smooth padding wastes ≤ 1.5x vs up to 2x for pure powers of
    two, and factors cleanly for the engine."""
    best = 1
    while best < n:
        best *= 2
    p3 = 1
    while True:
        p2 = 1
        while p2 * p3 < n:
            p2 *= 2
        best = min(best, p2 * p3)
        if p3 >= n:  # include the pure power of 3 ≥ n, then stop
            break
        p3 *= 3
    return best


def blue_sub_len(n: int) -> int:
    """Bluestein convolution length M >= 2n-1 for transform size n.

    Plain ``next_smooth`` picks the FLOP-minimal 3-smooth M; above 256
    this picks the smallest 3-smooth multiple of 128 instead, for <= 1/3
    extra padding (2049 -> M=4608, +5.3%), which keeps the sub-FFTs'
    stage matmuls on whole 128-wide tiles. Whether the FLOP-minimal M is
    faster on the GPU is not measured yet.
    """
    need = 2 * n - 1
    M = next_smooth(need)
    if M <= 256 or M % 128 == 0:
        return M
    s = next_smooth(-(-need // 128))
    if s <= 512:  # twostep range: m=128 needs f=M/128 <= 256; m=256 covers 512
        return 128 * s
    return M


# --------------------------------------------------------------------------
# Angle-accurate constant tables (numpy, f64 masters; cast at trace time)
# --------------------------------------------------------------------------


def _cis(num: np.ndarray, den: int, sign: int):
    """exp(sign * 1j * pi * num / den) with integer phase reduction mod 2*den."""
    num = np.asarray(num, dtype=np.int64) % (2 * den)
    ang = (np.pi / den) * num.astype(np.float64)
    if sign < 0:
        ang = -ang
    return np.cos(ang), np.sin(ang)


def dft_matrix(f: int, sign: int):
    """(f, f) DFT matrix W[t, k] = exp(sign*2j*pi*t*k/f), split re/im."""
    from . import native

    r = native.dft_matrix_native(f, sign)
    if r is not NotImplemented:
        return r
    tk = np.outer(np.arange(f, dtype=np.int64), np.arange(f, dtype=np.int64))
    return _cis(2 * tk, f, sign)


def stage_twiddle(f: int, m: int, sign: int):
    """(f, m) twiddle W_n^{j*p} for n = f*m, split re/im."""
    from . import native

    r = native.stage_twiddle_native(f, m, sign)
    if r is not NotImplemented:
        return r
    jp = np.outer(np.arange(f, dtype=np.int64), np.arange(m, dtype=np.int64))
    return _cis(2 * jp, f * m, sign)


def chirp(n: int, sign: int, length: Optional[int] = None):
    """exp(sign * 1j * pi * t^2 / n) for t in [0, length), split re/im."""
    length = length if length is not None else n
    from . import native

    r = native.chirp_native(n, sign, length)
    if r is not NotImplemented:
        return r
    t = np.arange(length, dtype=np.int64)
    return _cis(t * t, n, sign)


# --------------------------------------------------------------------------
# Plan structures
# --------------------------------------------------------------------------


class C2CPlan:
    """Static schedule for a length-n C2C FFT in one direction.
    (Cached per (n, sign, max_base_radix) via get_c2c_plan.)

    kind == 'ct':        `stages` is a list of (f, m, Wf(re,im), tw(re,im));
                         `base` is the (re, im) dense DFT matrix of the last
                         factor. Executed recursively by the engine.
    kind == 'bluestein': chirp_a/chirp_b (n,), H (M,) spectrum of the wrapped
                         inverse chirp, and `sub_fwd`/`sub_inv` C2C plans of
                         the 3-smooth padded length M (see blue_sub_len).
    """

    __slots__ = ("n", "sign", "kind", "stages", "base", "M",
                 "chirp_a", "chirp_b", "H", "sub_fwd", "sub_inv")

    def __init__(self, n: int, sign: int):
        assert sign in (-1, 1)
        self.n = n
        self.sign = sign
        factors = factorize(n)
        if factors is not None:
            self.kind = "ct"
            self.stages = []
            rem = n
            for f in factors[:-1]:
                m = rem // f
                self.stages.append((f, m, dft_matrix(f, sign), stage_twiddle(f, m, sign)))
                rem = m
            self.base = dft_matrix(factors[-1], sign)
        else:
            self.kind = "bluestein"
            M = blue_sub_len(n)
            self.M = M
            self.chirp_a = chirp(n, sign)
            self.chirp_b = chirp(n, sign)
            # wrapped inverse chirp h[u] = exp(-sign*1j*pi*u^2/n), u = 0..n-1
            # mirrored into tail: h_pad[M-u] = h[u]
            hr = np.zeros(M)
            hi = np.zeros(M)
            cr, ci = chirp(n, -sign)
            hr[:n], hi[:n] = cr, ci
            hr[M - n + 1:] = cr[1:][::-1]
            hi[M - n + 1:] = ci[1:][::-1]
            # H = FFT_M(h_pad), computed at plan time in f64 via numpy
            H = np.fft.fft(hr + 1j * hi)
            self.H = (H.real.copy(), H.imag.copy())
            self.sub_fwd = C2CPlan(M, -1)
            self.sub_inv = C2CPlan(M, +1)

    @property
    def num_stages(self) -> Optional[int]:
        """Stage count for 'ct' plans; None for Bluestein plans."""
        return (len(self.stages) + 1) if self.kind == "ct" else None

    def __repr__(self):
        if self.kind == "ct":
            fs = [f for f, _, _, _ in self.stages] + [self.base[0].shape[0]]
            return f"C2CPlan(n={self.n}, sign={self.sign}, factors={fs})"
        return f"C2CPlan(n={self.n}, sign={self.sign}, bluestein M={self.M})"


def get_c2c_plan(n: int, sign: int) -> C2CPlan:
    # resolve the radix toggle before the cache so runtime changes apply
    return _get_c2c_plan(n, sign, config.max_base_radix)


@lru_cache(maxsize=512)
def _get_c2c_plan(n: int, sign: int, _max_base: int) -> C2CPlan:
    return C2CPlan(n, sign)


class R2CPlan:
    """R2C forward schedule. Even n: half-size complex FFT + split/merge
    unpack twiddles (the realfft trick, SURVEY.md §2.2 N2). Odd n: full C2C
    of the complexified input, truncated to m = n//2 + 1 bins."""

    __slots__ = ("n", "m", "half", "sub", "unpack_tw")

    def __init__(self, n: int):
        self.n = n
        self.m = n // 2 + 1
        self.half = n % 2 == 0 and n >= 2
        if self.half:
            self.sub = get_c2c_plan(n // 2, -1)
            # W_n^k for k = 0..m-1 (forward sign)
            k = np.arange(self.m, dtype=np.int64)
            self.unpack_tw = _cis(2 * k, n, -1)
        else:
            self.sub = get_c2c_plan(n, -1)
            self.unpack_tw = None


def get_r2c_plan(n: int) -> R2CPlan:
    return _get_r2c_plan(n, config.max_base_radix)


@lru_cache(maxsize=512)
def _get_r2c_plan(n: int, _max_base: int) -> R2CPlan:
    return R2CPlan(n)
