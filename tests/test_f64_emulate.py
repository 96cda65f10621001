"""float64 transforms: the public functions in native f64, and the
double-float (two-float32) core of ops/df64.py.

Native f64 (``complex128``/``float64`` inputs) is the library's f64 path
on every backend (reference capability: f64 is a first-class dtype,
reference src/lib.rs:105-115). These tests pin it at 1e-12 against
numpy/scipy through the public API — roundtrips, every normalization
policy, the c2r DC/Nyquist edge semantics, DCT/DST, primes, under jit and
through ``warmup``.

The double-float core (a dot-free elementwise Stockham over (hi, lo) f32
pairs, ~5e-15 relative) stays as the f32-only representation that the
pencil layer's ``fftn_pencil_dd`` moves over all_to_all; its numerics,
f32 purity and distributed form are pinned here too.

Test names ending in ``_emulated``/``_under_emulate`` or naming a policy
date from the f64 emulation policy this library no longer has. They are
kept so each test's history can be followed; every one of them now runs
native f64, as its body and docstring say.
"""

import numpy as np
import pytest
import scipy.fft as sfft

import jax
import jax.numpy as jnp

import ndrustfft_tpu as nd
from ndrustfft_tpu.ops import df64

RTOL = 1e-12


def relerr(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    scale = max(np.max(np.abs(b)), 1e-30)
    return np.max(np.abs(a - b)) / scale


# --------------------------------------------------------------------------
# core numerics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 8, 64, 1024, 6, 100, 509, 1021])
def test_c2c_core_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    assert relerr(df64.c2c(x, -1), np.fft.fft(x)) < RTOL
    assert relerr(df64.c2c(x, +1), np.fft.ifft(x) * n) < RTOL


@pytest.mark.parametrize("n", [4, 7, 64, 129, 513])
def test_r2c_c2r_core(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n))
    assert relerr(df64.r2c(x), np.fft.rfft(x)) < RTOL
    m = n // 2 + 1
    xh = rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))
    assert relerr(df64.c2r(xh / n, n), np.fft.irfft(xh, n)) < RTOL


@pytest.mark.parametrize("n", [4, 7, 64, 129])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_dct_dst_core(n, t):
    rng = np.random.default_rng(10 * n + t)
    x = rng.standard_normal((3, n))
    # rustdct convention == scipy/2 (normalization.py pins the x2 Default)
    assert relerr(2 * df64.dct(x, t), sfft.dct(x, type=t)) < RTOL
    assert relerr(2 * df64.dst(x, t), sfft.dst(x, type=t)) < RTOL


@pytest.mark.parametrize("n", [64, 100])
def test_core_is_f32_pure(n):
    """The traced core contains no f64 type: the double-float
    representation is f32 end to end."""
    from ndrustfft_tpu.ops.df64 import _core, _split64

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    rh, rl = _split64(x.real)
    ih, il = _split64(x.imag)
    jaxpr = jax.make_jaxpr(lambda a, b, c, d: _core(n, -1)(a, b, c, d))(
        rh, rl, ih, il)
    text = str(jaxpr)
    assert "f64" not in text and "c128" not in text and "f128" not in text


def test_split64_rounding():
    """hi + lo reproduces the f64 value to the double-float precision
    (~2^-49 relative: two f32s carry ~48 mantissa bits vs f64's 53)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal(1000) * 10.0 ** rng.integers(-20, 20, 1000)
    hi, lo = df64._split64(a)
    back = hi.astype(np.float64) + lo.astype(np.float64)
    assert np.max(np.abs(back - a) / np.abs(a)) < 2.0 ** -48


# --------------------------------------------------------------------------
# native f64 through the public API
# --------------------------------------------------------------------------


def test_ndfft_roundtrip_emulated():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 64)) + 1j * rng.standard_normal((6, 64))
    h = nd.FftHandler(64)
    y = nd.ndfft(x, h, axis=1)
    assert isinstance(y, jax.Array)
    assert y.dtype == jnp.complex128
    assert relerr(y, np.fft.fft(x, axis=1)) < RTOL
    back = nd.ndifft(np.asarray(y), h, axis=1)
    assert relerr(back, x) < RTOL  # Default norm = 1/n after


def test_ndfft_axis0_and_real_input():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((12, 5))  # real f64 -> complexified
    y = nd.ndfft(x, nd.FftHandler(12), axis=0)
    assert relerr(y, np.fft.fft(x, axis=0)) < RTOL


def test_norm_modes_emulated():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16)) + 1j * rng.standard_normal((2, 16))
    none = nd.FftHandler(16).normalization(nd.Normalization.NONE)
    assert relerr(nd.ndifft(x, none, axis=1), np.fft.ifft(x, axis=1) * 16) < RTOL
    scal = nd.FftHandler(16).normalization(nd.Normalization.scalar(0.25))
    assert relerr(nd.ndifft(x, scal, axis=1),
                  np.fft.ifft(x, axis=1) * 16 * 0.25) < RTOL
    cust = nd.FftHandler(16).normalization(
        nd.Normalization.custom(lambda v: v * 3.0))
    assert relerr(nd.ndifft(x, cust, axis=1),
                  np.fft.ifft(x, axis=1) * 16 * 3.0) < RTOL


@pytest.mark.parametrize("n", [8, 9])
def test_c2r_edge_semantics_emulated(n):
    """Reference src/lib.rs:516-521 (test :1136-1167): garbage imag parts
    on the DC (and, for even n, Nyquist) bins must not change the result."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, n))
    h = nd.R2cFftHandler(n)
    spec = np.array(nd.ndfft_r2c(x, h, axis=1))  # copy: jax buffers are read-only
    spec[..., 0] += 100.0j
    if n % 2 == 0:
        spec[..., -1] += 100.0j
    back = nd.ndifft_r2c(spec, h, axis=1)
    assert relerr(back, x) < RTOL
    assert np.asarray(back).dtype == np.float64


@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_dct_dst_emulated_vs_scipy(t):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 33))
    ydct = getattr(nd, f"nddct{t}")(x, nd.DctHandler(33), axis=1)
    assert relerr(ydct, sfft.dct(x, type=t, axis=1)) < RTOL
    ydst = getattr(nd, f"nddst{t}")(x, nd.DstHandler(33), axis=1)
    assert relerr(ydst, sfft.dst(x, type=t, axis=1)) < RTOL


def test_dct_custom_norm_emulated():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 10))
    h = nd.DctHandler(10).normalization(
        nd.Normalization.custom(lambda v: v * 2.0))
    y = nd.nddct2(x, h, axis=1)
    assert relerr(y, sfft.dct(x, type=2, axis=1)) < RTOL


def test_prime_size_emulated():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 127)) + 1j * rng.standard_normal((2, 127))
    y = nd.ndfft(x, nd.FftHandler(127), axis=1)
    assert relerr(y, np.fft.fft(x, axis=1)) < RTOL


def test_tracer_raises_under_emulate():
    """f64 traced inside a user jit runs natively (no eager-only tier)."""
    h = nd.FftHandler(8)
    x = np.random.default_rng(10).standard_normal(8) + 0j

    def f(z):
        return nd.ndfft(z, h, axis=0)

    y = jax.jit(f)(jnp.asarray(x, jnp.complex128))
    assert y.dtype == jnp.complex128
    assert relerr(y, np.fft.fft(x)) < RTOL


def test_jax_cpu_arrays_not_intercepted():
    """A jax f64 array and a numpy f64 array take the same native path."""
    x = np.random.default_rng(11).standard_normal((4, 8)).astype(np.complex128)
    y = nd.ndfft(jnp.asarray(x), nd.FftHandler(8), axis=1)
    assert relerr(y, np.fft.fft(x, axis=1)) < RTOL
    assert relerr(nd.ndfft(x, nd.FftHandler(8), axis=1), y) < RTOL


def test_warmup_under_emulate():
    """warmup(float64=True) compiles the f64 entry that dispatch then
    hits, and the warmed call is correct."""
    from ndrustfft_tpu.api import _config_key, _jitted

    h = nd.FftHandler(16)
    h.warmup((4, 16), axis=1, float64=True)
    assert _jitted("fft", h, 1, _config_key())._cache_size() >= 1
    x = np.random.default_rng(12).standard_normal((4, 16)) + 0j
    assert relerr(nd.ndfft(x, h, axis=1), np.fft.fft(x, axis=1)) < RTOL


def test_inactive_without_policy():
    """numpy f64 inputs take the normal jit path and stay f64."""
    x = np.random.default_rng(12).standard_normal((2, 8)).astype(np.complex128)
    y = nd.ndfft(x, nd.FftHandler(8), axis=1)
    assert y.dtype == jnp.complex128
    assert relerr(y, np.fft.fft(x, axis=1)) < RTOL


def test_c2c_dd_traceable_inside_jit():
    """The double-float C2C core is traceable inside a user jit on device
    arrays — the program is f32-only (split64 pairs) — and the results
    match numpy f64 to the double-float accuracy."""
    import jax

    from ndrustfft_tpu.ops import df64

    rng = np.random.default_rng(13)
    x = rng.standard_normal((4, 256)) + 1j * rng.standard_normal((4, 256))
    leaves = df64.split64(x)
    assert all(leaf.dtype == np.float32 for leaf in leaves)

    @jax.jit
    def prog(rh, rl, ih, il):
        # forward then Default-normalized inverse, all inside one jit
        fw = df64.c2c_dd(rh, rl, ih, il, sign=-1, axis=1)
        return df64.c2c_dd(*fw, sign=+1, axis=1, scale=1.0 / 256)

    out = prog(*[jnp.asarray(v) for v in leaves])
    got = df64.join64(*[np.asarray(o) for o in out])
    assert relerr(got, x) < 1e-13            # true-f64-tier roundtrip
    fw = df64.c2c_dd(*[jnp.asarray(v) for v in leaves], sign=-1, axis=1)
    gotf = df64.join64(*[np.asarray(o) for o in fw])
    assert relerr(gotf, np.fft.fft(x, axis=1)) < 1e-13


def test_c2c_dd_length1_axis_applies_scale():
    """A length-1 DFT is the identity, but a requested scale must still
    apply (it carries a normalization fold, e.g. 1/n from the pencil dd
    inverse) — regression for the early return that dropped it."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1)) + 1j * rng.standard_normal((4, 1))
    leaves = [jnp.asarray(v) for v in df64.split64(x)]
    out = df64.c2c_dd(*leaves, sign=+1, axis=1, scale=0.5)
    got = df64.join64(*[np.asarray(o) for o in out])
    assert relerr(got, 0.5 * x) < 1e-15
    out2 = df64.c2c_dd(*leaves, sign=+1, axis=1)
    got2 = df64.join64(*[np.asarray(o) for o in out2])
    assert relerr(got2, x) < 1e-15


def test_c2c_dd_axis0_and_grad_composability():
    """c2c_dd composes with vmap (pure f32 jax ops) and honors axis."""
    import jax

    from ndrustfft_tpu.ops import df64

    rng = np.random.default_rng(14)
    x = rng.standard_normal((24, 3)) + 1j * rng.standard_normal((24, 3))
    leaves = [jnp.asarray(v) for v in df64.split64(x)]
    out = df64.c2c_dd(*leaves, sign=-1, axis=0)
    got = df64.join64(*[np.asarray(o) for o in out])
    assert relerr(got, np.fft.fft(x, axis=0)) < 1e-12  # Bluestein n=24

    vm = jax.vmap(lambda *ls: df64.c2c_dd(*ls, sign=-1, axis=0),
                  in_axes=1, out_axes=1)
    out_v = vm(*leaves)
    got_v = df64.join64(*[np.asarray(o) for o in out_v])
    assert relerr(got_v, got) < 1e-14


# ---------------------------------------------------------------------------
# distributed dd tier: the double-float accuracy rides the pencil path
# ---------------------------------------------------------------------------


def test_fftn_pencil_dd_3d_mesh():
    """The double-float tier over a 2x4 mesh: dd leaves ride the stacked
    plane dim through real all_to_all rotations, forward matches numpy
    f64 at dd accuracy and the roundtrip closes (reference f64 parity,
    src/lib.rs:105-115, now including the distributed layer)."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from ndrustfft_tpu.parallel import fftn_pencil_dd

    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 24, 20)) + 1j * rng.standard_normal(
        (16, 24, 20))
    leaves = df64.split64(x)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("py", "pz"))
    spec = P("py", "pz", None)
    sh = NamedSharding(mesh, spec)
    dl = [jax.device_put(np.asarray(l), sh) for l in leaves]
    outs, ospec = fftn_pencil_dd(*dl, mesh, spec)
    got = df64.join64(*[np.asarray(t) for t in outs])
    ref = np.fft.fftn(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < RTOL
    dl2 = [jax.device_put(np.asarray(t), NamedSharding(mesh, ospec))
           for t in outs]
    back, _ = fftn_pencil_dd(*dl2, mesh, ospec, inverse=True)
    rt = df64.join64(*[np.asarray(t) for t in back])
    assert np.abs(rt - x).max() < 1e-12


def test_plan_pencil_frozen_dims():
    """A frozen dim is never chosen as the all_to_all destination (it would
    scatter the dd planes), and with no other local dim available the plan
    fails loudly instead of silently splitting it."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from ndrustfft_tpu.handlers import FftHandler
    from ndrustfft_tpu.parallel import Step, plan_pencil

    mesh = Mesh(np.array(jax.devices()[:4]), ("py",))
    steps = [Step("fft_dd", 1, FftHandler(32))]
    plan, out_spec, *_ = plan_pencil((4, 32, 48), steps, mesh,
                                     P(None, "py", None), frozen_dims=(0,))
    assert plan[0] is not None and plan[0]["split"] == 2  # not the plane dim
    with pytest.raises(ValueError, match="no local dim"):
        plan_pencil((4, 32), steps, mesh, P(None, "py"), frozen_dims=(0,))


def test_dd_steps_honor_normalization_policy():
    """Round-5 advisor fix: the dd step kinds derive their scale from the
    handler's policy (reference C2C semantics: forward unnormalized,
    inverse scaled after) instead of hard-coding Default's 1/n; a custom
    callable raises with guidance (it cannot see values in the split
    plane representation)."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from ndrustfft_tpu import FftHandler, Normalization, df64
    from ndrustfft_tpu.parallel import Step, pencil_transform

    rng = np.random.default_rng(3)
    n = 16
    x = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    leaves = jnp.stack([jnp.asarray(p) for p in df64.split64(x)])
    mesh = Mesh(np.array(jax.devices()[:4]), ("py",))
    spec = P(None, "py", None)

    def run(handler, kind):
        out, _ = pencil_transform(leaves, [Step(kind, 2, handler)], mesh,
                                  spec, frozen_dims=(0,))
        return df64.join64(*[np.asarray(out[i]) for i in range(4)])

    fwd = np.fft.fft(x, axis=1)
    # NONE policy: inverse stays unnormalized
    h_none = FftHandler(n).normalization(Normalization.NONE)
    got = run(h_none, "ifft_dd")
    ref = np.fft.ifft(x, axis=1) * n
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12
    # scalar policy: the exact scalar rides the dd multiply
    h_s = FftHandler(n).normalization(Normalization.scalar(0.25))
    got = run(h_s, "ifft_dd")
    ref = np.fft.ifft(x, axis=1) * n * 0.25
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12
    # forward is NEVER normalized, any policy (src/lib.rs:313-318)
    got = run(h_s, "fft_dd")
    assert np.abs(got - fwd).max() / np.abs(fwd).max() < 1e-12
    # custom raises with guidance
    h_c = FftHandler(n).normalization(Normalization.custom(lambda v: v))
    with pytest.raises(ValueError, match="dd"):
        run(h_c, "ifft_dd")
