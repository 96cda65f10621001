"""Double-float (two-float32) transforms: ~1e-13 accuracy from f32 ops only.

Native f64 (``complex128``/``float64`` inputs to the public functions) is
the library's f64 path on every backend. This module keeps a dot-free
double-float core whose programs contain only f32 operations: a radix-2
Stockham autosort FFT (plus Bluestein for non-power-of-two n) built from
elementwise adds/multiplies over double-float numbers — (hi, lo) pairs of
f32 carrying ~49 mantissa bits (eps ~ 3.6e-15) — combined with the classic
error-free transformations, Knuth two-sum and Dekker two-product with
Veltkamp splitting (exact in IEEE round-to-nearest f32; XLA does not
reassociate or FMA-contract elementwise float HLO, so the transformations
survive compilation). Its traceable form :func:`c2c_dd` rides the pencil
layer (``parallel.fftn_pencil_dd``), where every all_to_all moves plain f32
planes.

The f64 <-> (hi, lo) split/recombine and the real/DCT/DST embeddings into
C2C run host-side in exact (or f64-level) numpy. This is an accuracy tier,
not a perf path: expect elementwise speeds, well below the engine's.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["c2c", "r2c", "c2r", "dct", "dst",
           "c2c_dd", "split64", "join64"]

_SPLITTER = np.float32(4097.0)  # 2^12 + 1 — Veltkamp split for 24-bit f32


# --------------------------------------------------------------------------
# double-float primitives (traced; every leaf is an f32 jnp array)
# --------------------------------------------------------------------------


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    # requires |a| >= |b| (holds at every use site below)
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    p = a * b
    t = _SPLITTER * a
    ah = t - (t - a)
    al = a - ah
    t = _SPLITTER * b
    bh = t - (t - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _dd_add(x, y):
    s, e = _two_sum(x[0], y[0])
    t, f = _two_sum(x[1], y[1])
    e = e + t
    s, e = _quick_two_sum(s, e)
    e = e + f
    return _quick_two_sum(s, e)


def _dd_sub(x, y):
    return _dd_add(x, (-y[0], -y[1]))


def _dd_mul(x, y):
    p, e = _two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _quick_two_sum(p, e)


# complex double-float: ((re_hi, re_lo), (im_hi, im_lo))


def _cadd(a, b):
    return (_dd_add(a[0], b[0]), _dd_add(a[1], b[1]))


def _csub(a, b):
    return (_dd_sub(a[0], b[0]), _dd_sub(a[1], b[1]))


def _cmul(a, b):
    return (_dd_sub(_dd_mul(a[0], b[0]), _dd_mul(a[1], b[1])),
            _dd_add(_dd_mul(a[0], b[1]), _dd_mul(a[1], b[0])))


def _cmap(f, z):
    """Apply f to each of the four f32 leaves of a complex double-float."""
    return tuple(tuple(f(leaf) for leaf in part) for part in z)


# --------------------------------------------------------------------------
# host-side constants
# --------------------------------------------------------------------------


def _split64(a):
    """Split an f64 array into (hi, lo) f32 with hi + lo == a to ~2^-49
    relative (two f32s carry ~48 mantissa bits vs f64's 53; the split is
    correctly rounded, which sets this tier's accuracy floor)."""
    hi = np.asarray(a, np.float32)
    lo = np.asarray(a - hi.astype(np.float64), np.float32)
    return hi, lo


def _cconst(vals):
    """c128 1-D host array -> complex double-float of jnp consts (1, m, 1)."""
    import jax.numpy as jnp

    def mk(part):
        hi, lo = _split64(part)
        return (jnp.asarray(hi.reshape(1, -1, 1)),
                jnp.asarray(lo.reshape(1, -1, 1)))

    return (mk(vals.real), mk(vals.imag))


# --------------------------------------------------------------------------
# the Stockham core
# --------------------------------------------------------------------------


def _pow2_fft(z, n, sign):
    """Radix-2 Stockham autosort over components shaped (B, n, 1).

    OTFFT-style DIF recurrence: at each stage the (B, L, s) problem array
    becomes (B, L/2, 2s) via top = a + b, bot = (a - b) * w — autosorting,
    so the final (B, 1, n) is in natural order with no bit-reversal gather.
    """
    import jax.numpy as jnp

    L = n
    while L > 1:
        m = L // 2
        p = np.arange(m, dtype=np.float64)
        ang = (2.0 * np.pi * sign) * (p / L)
        w = _cconst(np.cos(ang) + 1j * np.sin(ang))
        a = _cmap(lambda t: t[:, :m, :], z)
        b = _cmap(lambda t: t[:, m:, :], z)
        top = _cadd(a, b)
        bot = _cmul(_csub(a, b), w)

        def comb(t, u):
            st = jnp.stack([t, u], axis=2)
            return st.reshape(st.shape[0], m, -1)

        z = tuple(tuple(comb(tl, ul) for tl, ul in zip(tp, up))
                  for tp, up in zip(top, bot))
        L = m
    return z


def _next_pow2(v: int) -> int:
    return 1 << (v - 1).bit_length()


def _chirp(n: int, sign: int):
    """e^{sign * i*pi*t^2/n}, t = 0..n-1, with t^2 reduced mod 2n (exact)."""
    t = np.arange(n, dtype=np.int64)
    return np.exp((1j * np.pi * sign / n) * ((t * t) % (2 * n)))


@functools.lru_cache(maxsize=512)
def _core(n: int, sign: int):
    """jitted (rh, rl, ih, il) (B, n) -> same, the unnormalized C2C FFT."""
    import jax
    import jax.numpy as jnp

    pow2 = n & (n - 1) == 0

    if not pow2:
        # Bluestein: y_k = chirp_k * IFFT_M(FFT_M(x * chirp) * H)[k], with
        # chirp_t = e^{sign*i*pi*t^2/n} and H the M-point FFT of the wrapped
        # conjugate chirp (host f64 constants; M = next pow2 >= 2n-1)
        M = _next_pow2(2 * n - 1)
        ch = _chirp(n, sign)
        b = np.zeros(M, np.complex128)
        b[:n] = np.conj(ch)
        b[M - n + 1:] = np.conj(ch[1:][::-1])
        Hv = np.fft.fft(b)
        inv_m = np.float32(1.0 / M)  # exact: M is a power of two

    def fn(rh, rl, ih, il):
        z = (((rh[:, :, None]), (rl[:, :, None])),
             ((ih[:, :, None]), (il[:, :, None])))
        if pow2:
            z = _pow2_fft(z, n, sign)
        else:
            z = _cmul(z, _cconst(ch))
            pad = [(0, 0), (0, M - n), (0, 0)]
            z = _cmap(lambda t: jnp.pad(t, pad), z)
            z = _cmap(lambda t: t.reshape(t.shape[0], M, 1),
                      _pow2_fft(z, M, -1))
            z = _cmul(z, _cconst(Hv))
            z = _cmap(lambda t: t.reshape(t.shape[0], M, 1),
                      _pow2_fft(z, M, +1))
            z = _cmap(lambda t: t * inv_m, z)  # exact pow2 scale
            z = _cmul(_cmap(lambda t: t[:, :n, :], z), _cconst(ch))
        (rh2, rl2), (ih2, il2) = z
        sq = lambda t: t.reshape(t.shape[0], n)
        return sq(rh2), sq(rl2), sq(ih2), sq(il2)

    return jax.jit(fn)


def c2c(x, sign: int):
    """Unnormalized C2C FFT along the LAST axis of a host f64/c128 array.

    ``sign=-1`` forward, ``+1`` the unnormalized inverse. Input is split to
    (hi, lo) f32 pairs on the host, the f32-only core runs on the default
    JAX backend, and the result recombines to complex128 on the host.
    """
    x = np.asarray(x, np.complex128)
    n = x.shape[-1]
    if n == 1:
        return x.copy()
    shape = x.shape
    xf = x.reshape(-1, n)
    rh, rl = _split64(xf.real)
    ih, il = _split64(xf.imag)
    yrh, yrl, yih, yil = _core(n, sign)(rh, rl, ih, il)
    yr = np.asarray(yrh, np.float64) + np.asarray(yrl, np.float64)
    yi = np.asarray(yih, np.float64) + np.asarray(yil, np.float64)
    return (yr + 1j * yi).reshape(shape)


# --------------------------------------------------------------------------
# family embeddings (host f64 pre/post around the device core; these are
# unnormalized — a caller applies the normalization policy)
# --------------------------------------------------------------------------


def split64(x):
    """Host f64 (or c128) array -> double-float f32 leaves.

    Real input: ``(hi, lo)``; complex input: ``(re_hi, re_lo, im_hi,
    im_lo)``. The pairs satisfy hi + lo == x to ~2^-49 relative. This is
    the boundary into the jittable double-float tier: the leaves are plain
    f32 arrays, so they cross shard_map and all_to_all as f32 and can be
    passed through a user ``jax.jit``.
    """
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.complexfloating):
        x = x.astype(np.complex128)
        return (*_split64(x.real), *_split64(x.imag))
    return _split64(x.astype(np.float64))


def join64(*leaves):
    """Inverse of :func:`split64`: (hi, lo) -> f64, or the 4-leaf complex
    form -> c128 (host numpy)."""
    if len(leaves) == 2:
        return (np.asarray(leaves[0], np.float64)
                + np.asarray(leaves[1], np.float64))
    if len(leaves) == 4:
        return join64(*leaves[:2]) + 1j * join64(*leaves[2:])
    raise ValueError("join64 takes (hi, lo) or (re_hi, re_lo, im_hi, im_lo)")


def c2c_dd(rh, rl, ih, il, sign: int = -1, axis: int = -1, scale=None):
    """TRACEABLE double-float C2C FFT along ``axis`` (unnormalized).

    The jittable form of the double-float tier: operands and results are
    the four f32 double-float leaves from :func:`split64`, so the whole
    computation is f32-only and can be traced inside a user ``jax.jit``,
    composed with ``vmap``/``shard_map``, and chained without host
    round-trips. Accuracy matches the eager :func:`c2c` (~5e-15 relative
    at n<=1024).

    ``scale``: optional f64 scalar folded in as an exact double-float
    multiply (use 1/n for a Default-normalized inverse).
    """
    import jax.numpy as jnp

    axis = axis % rh.ndim
    n = rh.shape[axis]
    if n == 1:
        # a length-1 DFT is the identity, but a requested scale still applies
        if scale is None:
            return rh, rl, ih, il
        sh, sl = _split64(np.float64(scale))
        s_dd = (jnp.asarray(sh), jnp.asarray(sl))
        re = _dd_mul((rh, rl), s_dd)
        im = _dd_mul((ih, il), s_dd)
        return re[0], re[1], im[0], im[1]
    parts = (rh, rl, ih, il)

    def prep(t):
        return jnp.moveaxis(t, axis, -1).reshape(-1, n)

    # the lru-cached jit inlines when traced inside an outer jit
    outs = _core(n, sign)(*map(prep, parts))
    if scale is not None:
        sh, sl = _split64(np.float64(scale))
        s_dd = (jnp.asarray(sh), jnp.asarray(sl))
        re = _dd_mul((outs[0], outs[1]), s_dd)
        im = _dd_mul((outs[2], outs[3]), s_dd)
        outs = (*re, *im)
    moved = jnp.moveaxis(rh, axis, -1).shape

    def post(t):
        return jnp.moveaxis(t.reshape(moved), -1, axis)

    return tuple(post(t) for t in outs)


def r2c(x):
    """Real n -> m = n//2+1 spectrum bins (forward, unnormalized)."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    return c2c(x.astype(np.complex128), -1)[..., :n // 2 + 1]


def c2r(xhat, n: int):
    """m spectrum bins -> n reals with the reference's edge semantics
    (src/lib.rs:506-523): the DC bin's imaginary part is zeroed, and for
    even n the Nyquist bin's too, BEFORE the (unnormalized) inverse. The
    caller applies the normalization policy to the spectrum first."""
    b = np.array(xhat, np.complex128)
    b[..., 0] = b[..., 0].real
    if n % 2 == 0:
        b[..., -1] = b[..., -1].real
        interior = b[..., 1:-1]
    else:
        interior = b[..., 1:]
    full = np.concatenate([b, np.conj(interior[..., ::-1])], axis=-1)
    return c2c(full, +1).real


def dct(x, dct_type: int):
    """DCT-1..4 along the last axis, rustdct convention (== scipy/2), via
    exact even-extension / phase embeddings into the C2C core."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    if dct_type == 1:
        # even extension length 2n-2: FFT(v)_k = scipy dct1 exactly
        v = np.concatenate([x, x[..., n - 2:0:-1]], axis=-1)
        return 0.5 * c2c(v.astype(np.complex128), -1)[..., :n].real
    if dct_type == 2:
        # mirrored extension length 2n: FFT(v)_k = e^{i*pi*k/2n} * scipy2_k
        v = np.concatenate([x, x[..., ::-1]], axis=-1)
        V = c2c(v.astype(np.complex128), -1)[..., :n]
        k = np.arange(n)
        return 0.5 * (np.exp(-1j * np.pi * k / (2 * n)) * V).real
    if dct_type == 3:
        # spectrum c_k = x_k e^{i*pi*k/2n}, Hermitian-extended to 2n with a
        # zero Nyquist slot; Re(IFFT_unnorm(c))[:n] = scipy dct3
        k = np.arange(n)
        ck = x * np.exp(1j * np.pi * k / (2 * n))
        zeros = np.zeros_like(ck[..., :1])
        full = np.concatenate([ck, zeros, np.conj(ck[..., 1:][..., ::-1])],
                              axis=-1)
        return 0.5 * c2c(full, +1)[..., :n].real
    if dct_type == 4:
        # (2k+1)(2t+1) = 4kt + 2t + 2k + 1: pre-twiddle e^{-i*pi*t/2n},
        # zero-pad to 2n, post-twiddle e^{-i*pi*(2k+1)/4n}
        t = np.arange(n)
        u = x * np.exp(-1j * np.pi * t / (2 * n))
        u = np.concatenate([u, np.zeros_like(u)], axis=-1)
        U = c2c(u, -1)[..., :n]
        k = np.arange(n)
        return (np.exp(-1j * np.pi * (2 * k + 1) / (4 * n)) * U).real
    raise ValueError(f"unknown DCT type {dct_type}")


def dst(x, dst_type: int):
    """DST-1..4 along the last axis, rustdct convention, via the exact
    conjugations used by the product lowerings (ops/dst.py:53-86)."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    if dst_type == 1:
        # odd extension length 2n+2: base = -Im(FFT(v))[1:n+1] / 2
        z = np.zeros_like(x[..., :1])
        v = np.concatenate([z, x, z, -x[..., ::-1]], axis=-1)
        return -0.5 * c2c(v.astype(np.complex128), -1)[..., 1:n + 1].imag
    alt = np.where(np.arange(n) % 2, -1.0, 1.0)
    if dst_type == 2:
        return dct(x * alt, 2)[..., ::-1]
    if dst_type == 3:
        return dct(x[..., ::-1], 3) * alt
    if dst_type == 4:
        return dct(x[..., ::-1], 4) * alt
    raise ValueError(f"unknown DST type {dst_type}")
