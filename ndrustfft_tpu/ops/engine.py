"""Batched mixed-radix FFT engine on split re/im arrays (pure JAX/XLA).

This is the framework's own transform math — the replacement for the
rustfft/realfft butterfly kernels the reference delegates to (SURVEY.md §2.2
N1/N2). It is NOT a wrapper over ``jnp.fft`` (that is used only as a test
oracle). Everything here is reshape/matmul/elementwise: each stage is a
dense DFT contraction plus a twiddle multiply, which XLA lowers to GEMMs and
fused elementwise kernels.

Complex numbers are carried as (re, im) float array pairs, so every complex
contraction lowers to 4 real einsums without XLA's complex->real
legalization getting in the way.

Layout convention: the transformed axis is always the LAST axis here; axis
generality (the reference dispatcher's swap_axes/copy machinery,
src/lib.rs:100-167) is handled by the caller via moveaxis, which XLA fuses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import matmul_precision
from ..plan import C2CPlan, R2CPlan, get_c2c_plan


def _const(pair, dtype):
    """Cast a (re, im) numpy f64 constant pair to the working dtype."""
    return jnp.asarray(pair[0], dtype), jnp.asarray(pair[1], dtype)


def _cmul(ar, ai, br, bi):
    """Elementwise complex multiply."""
    return ar * br - ai * bi, ar * bi + ai * br


def c2c(xr, xi, plan: C2CPlan, scale=None):
    """Batched C2C FFT along the last axis. xr/xi: (..., n) real arrays.

    Unnormalized in both directions, matching rustfft semantics that the
    reference builds on (forward AND backward unnormalized; normalization is
    the handler's policy layer, reference src/lib.rs:313-338). ``scale``
    (python float) multiplies the result; XLA fuses the multiply into the
    last stage's epilogue.
    """
    if plan.kind == "bluestein":
        return _bluestein(xr, xi, plan, scale)
    dtype = xr.dtype
    stage_vals = [(f, m, _const(wf, dtype), _const(tw, dtype))
                  for f, m, wf, tw in plan.stages]
    base_vals = _const(plan.base, dtype)
    yr, yi = ct_valued(xr, xi, stage_vals, base_vals)
    if scale is not None:
        s = jnp.asarray(scale, dtype)
        yr, yi = yr * s, yi * s
    return yr, yi


# einsum letters for trailing residue dims (excludes the t/p/j/q used by the
# contraction specs); deep plans (e.g. max_base_radix=2, n=2^20) need one per
# stage
_TRAIL = "abcdeghiklmnorsuvwxyz"


def ct_valued(xr, xi, stages, base):
    """Recursive Cooley-Tukey over stage constants given as jnp VALUES
    (constants folded by jit).

    Derivation (DIT, k = q*m + p, t = f*t' + j):
      X[q*m + p] = sum_j W_f^{jq} * ( W_n^{jp} * FFT_m(x[j::f])[p] )

    TRANSPOSE-FREE: each level splits its axis in place and the residue dims
    accumulate as TRAILING batch dims; all data movement is expressed inside
    einsums, whose output ordering XLA folds into the dot_generals rather
    than materializing transposes. (An explicit-swapaxes formulation
    measured equal at the package level — XLA already folded it — but this
    form guarantees the folding instead of relying on the optimizer.)
    """
    if len(stages) > len(_TRAIL):
        raise ValueError(
            f"plan with {len(stages)} stages exceeds the engine's "
            f"{len(_TRAIL)}-level recursion support; raise max_base_radix")
    return _ct_at(xr, xi, stages, base, 0)


def _ct_at(xr, xi, stages, base, depth):
    prec = matmul_precision()
    trail = _TRAIL[:depth]
    if not stages:
        # contract the transform dim (position -1-depth) with the base DFT
        spec = f"tp,...t{trail}->...p{trail}"

        def con(a, w):
            return jnp.einsum(spec, w, a, precision=prec)

        t1r, t1i = con(xr, base[0]), con(xi, base[0])
        t2r, t2i = con(xr, base[1]), con(xi, base[1])
        return t1r - t2i, t1i + t2r
    f, m, (wfr, wfi), (twr, twi) = stages[0]
    ax = xr.ndim - 1 - depth
    shape = xr.shape
    split = shape[:ax] + (m, f) + shape[ax + 1:]
    # x[f*t' + j] -> xs[..., t', j, <trail>]; sub-FFT runs along t' with the
    # residue j joining the trailing batch dims
    yr, yi = _ct_at(xr.reshape(split), xi.reshape(split), stages[1:], base,
                    depth + 1)                     # (..., p, j, <trail>)
    twb = (m, f) + (1,) * depth
    yr, yi = _cmul(yr, yi, jnp.swapaxes(twr, 0, 1).reshape(twb),
                   jnp.swapaxes(twi, 0, 1).reshape(twb))
    # combine over j, landing q BEFORE p so (q, p) merges to k = q*m + p
    spec = f"jq,...pj{trail}->...qp{trail}"

    def con(a, w):
        return jnp.einsum(spec, w, a, precision=prec)

    t1r, t1i = con(yr, wfr), con(yi, wfr)
    t2r, t2i = con(yr, wfi), con(yi, wfi)
    outr = t1r - t2i
    outi = t1i + t2r
    merged = shape[:ax] + (f * m,) + shape[ax + 1:]
    return outr.reshape(merged), outi.reshape(merged)


def ct_first_valued(xr, xi, stages, base):
    """Cooley-Tukey along axis 0 with trailing batch dims — the transpose-free
    twin of :func:`ct_valued` for the reference's benchmark configuration
    (transform along axis 0 of a C-order 2-D array, benches/ndrustfft.rs:6):
    where the reference pays per-lane copies (src/lib.rs:125-137) and a
    moveaxis-based design pays an HBM transpose, this contracts directly over
    the leading axis.
    """
    if not stages:
        br, bi = base
        prec = matmul_precision()
        t1r = jnp.einsum("tk,t...->k...", br, xr, precision=prec)
        t1i = jnp.einsum("tk,t...->k...", br, xi, precision=prec)
        t2r = jnp.einsum("tk,t...->k...", bi, xr, precision=prec)
        t2i = jnp.einsum("tk,t...->k...", bi, xi, precision=prec)
        return t1r - t2i, t1i + t2r
    f, m, (wfr, wfi), (twr, twi) = stages[0]
    rest = xr.shape[1:]
    # x[f*t' + j, ...] -> xs[t', j, ...]; sub-FFT along t' with (j, rest) batch
    xr = xr.reshape((m, f) + rest)
    xi = xi.reshape((m, f) + rest)
    yr, yi = ct_first_valued(xr, xi, stages[1:], base)  # (p, j, ...)
    tw_shape = (m, f) + (1,) * len(rest)
    twr_t = jnp.swapaxes(twr, 0, 1).reshape(tw_shape)
    twi_t = jnp.swapaxes(twi, 0, 1).reshape(tw_shape)
    yr, yi = _cmul(yr, yi, twr_t, twi_t)
    # combine: out[q, p, ...] = sum_j wf[j, q] * y[p, j, ...]
    prec = matmul_precision()

    def comb(wj):
        return (jnp.einsum("jq,pj...->qp...", wj, yr, precision=prec),
                jnp.einsum("jq,pj...->qp...", wj, yi, precision=prec))

    t1r, t1i = comb(wfr)
    t2r, t2i = comb(wfi)
    outr = t1r - t2i
    outi = t1i + t2r
    return outr.reshape((f * m,) + rest), outi.reshape((f * m,) + rest)


def c2c_axis0(xr, xi, plan: C2CPlan, scale=None):
    """C2C FFT along axis 0 (trailing dims batch) without any HBM transpose.

    Bluestein plans use the lane-last path via moveaxis (rare sizes).
    ``scale`` as in :func:`c2c`."""
    if plan.kind == "bluestein":
        yr, yi = _bluestein(jnp.moveaxis(xr, 0, -1), jnp.moveaxis(xi, 0, -1),
                            plan, scale)
        return jnp.moveaxis(yr, -1, 0), jnp.moveaxis(yi, -1, 0)
    dtype = xr.dtype
    stage_vals = [(f, m, _const(wf, dtype), _const(tw, dtype))
                  for f, m, wf, tw in plan.stages]
    base_vals = _const(plan.base, dtype)
    yr, yi = ct_first_valued(xr, xi, stage_vals, base_vals)
    if scale is not None:
        s = jnp.asarray(scale, dtype)
        yr, yi = yr * s, yi * s
    return yr, yi


def _bluestein(xr, xi, plan: C2CPlan, scale=None):
    """Chirp-z: X[k] = b[k] * IFFT_M(FFT_M(x*a, pad) * H)[k], k < n."""
    dtype = xr.dtype
    n, M = plan.n, plan.M
    car, cai = _const(plan.chirp_a, dtype)
    ar, ai = _cmul(xr, xi, car, cai)
    pad = [(0, 0)] * (ar.ndim - 1) + [(0, M - n)]
    ar = jnp.pad(ar, pad)
    ai = jnp.pad(ai, pad)
    fr, fi = c2c(ar, ai, plan.sub_fwd)
    hr, hi = _const(plan.H, dtype)
    fr, fi = _cmul(fr, fi, hr, hi)
    # fold the user scale into the sub-inverse's fused 1/M normalization
    s = 1.0 / M if scale is None else float(scale) / M
    gr, gi = c2c(fr, fi, plan.sub_inv, scale=s)
    gr = gr[..., :n]
    gi = gi[..., :n]
    cbr, cbi = _const(plan.chirp_b, dtype)
    return _cmul(gr, gi, cbr, cbi)


# --------------------------------------------------------------------------
# R2C / C2R (the realfft capability, reference src/lib.rs:451-541)
# --------------------------------------------------------------------------


def r2c(x, plan: R2CPlan):
    """Real (..., n) -> half-spectrum (re, im) of shape (..., m), m = n//2+1.

    Even n uses the pack trick: z[t] = x[2t] + i*x[2t+1], one half-size C2C,
    then split/merge with the unpack twiddle. Odd n runs a full C2C on the
    complexified input and truncates. Unnormalized (reference applies no
    forward normalization, src/lib.rs:497-503).
    """
    n, m = plan.n, plan.m
    if not plan.half:
        batch = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
        if batch >= 2:
            return _r2c_rowpair(x, plan)
        zr, zi = c2c(x, jnp.zeros_like(x), plan.sub)
        return zr[..., :m], zi[..., :m]
    return r2c_packed(x[..., 0::2], x[..., 1::2], plan)


def _r2c_rowpair(x, plan: R2CPlan):
    """Odd-n batched R2C via ROW pairing: two real rows ride one complex
    FFT (z = row_a + i*row_b; A = (Z + conj(ZM))/2, B = -i(Z - conj(ZM))/2
    with ZM[k] = Z[(n-k) mod n]) — halves the FFT work vs complexifying
    each row with a zero imaginary part. Used for the reference's odd DCT
    bench sizes (129/265/513/1025) where the even-n pack trick can't apply.
    """
    n, m = plan.n, plan.m
    lead = x.shape[:-1]
    batch = int(np.prod(lead))
    xf = x.reshape(batch, n)
    if batch % 2:
        xf = jnp.concatenate([xf, jnp.zeros_like(xf[:1])], axis=0)
    zr, zi = c2c(xf[0::2], xf[1::2], plan.sub)
    # full-length mirror ZM[k] = Z[(n-k) mod n] via concat+flip (no gather)
    zmr = jnp.concatenate([zr[:, :1], zr[:, 1:][:, ::-1]], axis=-1)
    zmi = jnp.concatenate([zi[:, :1], zi[:, 1:][:, ::-1]], axis=-1)
    ar = 0.5 * (zr + zmr)
    ai = 0.5 * (zi - zmi)
    br = 0.5 * (zi + zmi)
    bi = -0.5 * (zr - zmr)
    sr = jnp.stack([ar, br], axis=1).reshape(-1, n)[:batch, :m]
    si = jnp.stack([ai, bi], axis=1).reshape(-1, n)[:batch, :m]
    return sr.reshape(lead + (m,)), si.reshape(lead + (m,))


def r2c_packed(xe, xo, plan: R2CPlan):
    """Half-spectrum from pre-split even/odd sample streams (..., h).

    Entry point for callers that can produce the interleaved streams
    directly from their own layout (e.g. the DCT-I even extension) without
    materializing the packed sequence; requires ``plan.half``.
    """
    zr, zi = c2c(xe, xo, plan.sub)  # FFT of z = xe + i*xo, length h
    # Z[k] for k = 0..h and the mirror Z[(h-k) mod h], built with
    # flip/concat (fuses into neighbours) instead of a gather:
    zrk = jnp.concatenate([zr, zr[..., :1]], axis=-1)  # Z[k], k=0..h
    zik = jnp.concatenate([zi, zi[..., :1]], axis=-1)
    zrm = jnp.concatenate([zr[..., :1], zr[..., 1:][..., ::-1], zr[..., :1]],
                          axis=-1)
    zim = jnp.concatenate([zi[..., :1], zi[..., 1:][..., ::-1], zi[..., :1]],
                          axis=-1)
    # Fe[k] = (Z[k] + conj(Z[-k]))/2 ; Fo[k] = (Z[k] - conj(Z[-k]))/(2i)
    fer = 0.5 * (zrk + zrm)
    fei = 0.5 * (zik - zim)
    forr = 0.5 * (zik + zim)
    foi = -0.5 * (zrk - zrm)
    twr, twi = _const(plan.unpack_tw, xe.dtype)
    tr, ti = _cmul(forr, foi, twr, twi)
    return fer + tr, fei + ti


def c2r(sr, si, n: int, scale=None, mask_dc_nyq=True):
    """Half-spectrum (..., m) -> real (..., n) via Hermitian extension + C2C.

    Implements the reference's full pre-step order (src/lib.rs:506-523):
    ``scale`` (the normalization, applied FIRST on the spectrum) then the
    DC — and for even n Nyquist — imag zeroing (``mask_dc_nyq``), then the
    unnormalized inverse. Both pre-steps are elementwise, so XLA fuses them
    into the Hermitian-extension pass.
    """
    m = n // 2 + 1
    dtype = sr.dtype
    if n == 1:
        y = sr[..., :1]
        return y * jnp.asarray(scale, dtype) if scale is not None else y
    if mask_dc_nyq:
        mask = jnp.ones((m,), dtype).at[0].set(0.0)
        if n % 2 == 0:
            mask = mask.at[m - 1].set(0.0)
        si = si * mask
    if scale is not None:
        s = jnp.asarray(scale, dtype)
        sr = sr * s
        si = si * s
    # bins m..n-1 are conj(X[n-k]): indices n-m..1 == flip of bins 1..n-m
    er = jnp.concatenate([sr, sr[..., 1:n - m + 1][..., ::-1]], axis=-1)
    ei = jnp.concatenate([si, -si[..., 1:n - m + 1][..., ::-1]], axis=-1)
    plan = get_c2c_plan(n, +1)
    yr, _ = c2c(er, ei, plan)
    return yr
