"""Routing-matrix regression: every (transform, size, axis, norm) combo,
through the public API, against the numpy/scipy float64 reference, with
the route each combination compiles to asserted through
``config.debug_plan_log``.

The sizes cover the distinct lowerings (mixed-radix and power-of-two
Cooley-Tukey, odd-n real transforms, the minor and middle axes) and every
normalization policy (Default, NONE, scalar and a nonlinear custom
callable, which catches application-point bugs).
"""

import numpy as np
import pytest
import scipy.fft as sfft

import jax.numpy as jnp
from ndrustfft_tpu import (
    DctHandler, DstHandler, FftHandler, Normalization, R2cFftHandler,
    nddct1, nddct2, nddct3, nddct4, nddst1, nddst2, nddst3, nddst4, ndfft,
    ndfft_r2c, ndifft, ndifft_r2c,
)
from ndrustfft_tpu.config import config

_DCT = {1: nddct1, 2: nddct2, 3: nddct3, 4: nddct4}
_DST = {1: nddst1, 2: nddst2, 3: nddst3, 4: nddst4}
_CUSTOM = lambda v: 0.3 * v + 0.01 * v * v  # noqa: E731 — nonlinear
_NORMS = {"default": None, "none": Normalization.NONE,
          "scalar": Normalization.scalar(0.3),
          "custom": Normalization.custom(_CUSTOM)}


def _policy(nname, v, default):
    """The normalization policy applied to ``v`` (numpy)."""
    return {"default": default * v, "none": v, "scalar": 0.3 * v,
            "custom": _CUSTOM(v)}[nname]


def _oracle(n, axis, xr, xc):
    """float64 reference for every (transform, policy) of ``_run_all``:
    C2C/C2R normalize after the unnormalized transform, DCT/DST before it
    (reference src/lib.rs:313-338, 506-523, 688-741)."""
    xr = xr.astype(np.float64)
    xc = xc.astype(np.complex128)
    out = {}
    for nname in _NORMS:
        out[("fft", nname)] = np.fft.fft(xc, axis=axis)
        out[("ifft", nname)] = _policy(
            nname, np.fft.ifft(xc, axis=axis) * n, 1.0 / n)
        sp = np.fft.rfft(xr, axis=axis)
        out[("r2c", nname)] = sp
        # the inverse sees the f32 spectrum ndfft_r2c returned; at the
        # roundtrip the policy turns n * x into the policy of n * x
        out[("c2r", nname)] = np.fft.irfft(
            _policy(nname, sp, 1.0 / n), n=n, axis=axis) * n
        for k in _DCT:
            out[(f"dct{k}", nname)] = sfft.dct(
                _policy(nname, xr, 2.0), type=k, axis=axis) / 2
            out[(f"dst{k}", nname)] = sfft.dst(
                _policy(nname, xr, 2.0), type=k, axis=axis) / 2
    return out


def _run_all(n, axis, xr, xc):
    out = {}
    for nname, nm in _NORMS.items():
        hf = FftHandler(n) if nm is None else FftHandler(n).normalization(nm)
        hr = (R2cFftHandler(n) if nm is None
              else R2cFftHandler(n).normalization(nm))
        hd = DctHandler(n) if nm is None else DctHandler(n).normalization(nm)
        out[("fft", nname)] = np.asarray(ndfft(jnp.asarray(xc), hf, axis=axis))
        out[("ifft", nname)] = np.asarray(
            ndifft(jnp.asarray(xc), hf, axis=axis))
        sp = ndfft_r2c(jnp.asarray(xr), hr, axis=axis)
        out[("r2c", nname)] = np.asarray(sp)
        out[("c2r", nname)] = np.asarray(ndifft_r2c(sp, hr, axis=axis))
        for k, fn in _DCT.items():
            out[(f"dct{k}", nname)] = np.asarray(
                fn(jnp.asarray(xr), hd, axis=axis))
        hs = DstHandler(n) if nm is None else DstHandler(n).normalization(nm)
        for k, fn in _DST.items():
            out[(f"dst{k}", nname)] = np.asarray(
                fn(jnp.asarray(xr), hs, axis=axis))
    return out


@pytest.mark.parametrize("n,shape,axis", [
    (264, (2, 264, 16), 1),    # mixed radix 8*3*11, middle axis
    (512, (2, 512, 16), 1),    # power of two, middle axis
    (129, (2, 129, 16), 1),    # odd: odd r2c, odd DCT Makhoul
    (1024, (2, 1024, 16), 1),  # headline size, middle axis
    (264, (16, 264), 1),       # lane-last orientation
])
def test_routing_matrix_pallas_vs_engine(n, shape, axis, capsys):
    from ndrustfft_tpu.api import _jitted

    rng = np.random.default_rng(n)
    xr = rng.standard_normal(shape).astype(np.float32)
    xc = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    old = config.debug_plan_log
    try:
        config.debug_plan_log = True
        _jitted.cache_clear()
        got = _run_all(n, axis, xr, xc)
        err = capsys.readouterr().err
    finally:
        config.debug_plan_log = old
        _jitted.cache_clear()
    moved = "" if axis == len(shape) - 1 else "+moveaxis"
    half = "half" if n % 2 == 0 else "odd"
    for route in (f"fft n={n} axis={axis} -> engine-lane-last{moved}",
                  f"r2c n={n} axis={axis} -> engine-r2c-{half}{moved}",
                  f"c2r n={n} axis={axis} -> engine-c2r{moved}",
                  f"dct2 n={n} axis={axis} -> engine-dct{moved}",
                  f"dst1 n={n} axis={axis} -> engine-dst1{moved}"):
        assert route + "\n" in err, (route, err)
    # c2r inverts the f32 spectrum the forward returned, so its reference
    # starts from that spectrum
    want = _oracle(n, axis, xr, xc)
    for key in got:
        ref = want[key]
        if key[0] == "c2r":
            nname = key[1]
            ref = np.fft.irfft(_policy(nname, got[("r2c", nname)].astype(
                np.complex128), 1.0 / n), n=n, axis=axis) * n
        e = np.abs(got[key] - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert e < 1e-3, (n, shape, axis, key, e)


def test_custom_normalization_keeps_kernel_route(capsys):
    """A Normalization.custom policy keeps the engine route: the callable
    runs as one fused XLA prologue/epilogue at the reference's application
    point (ifft: after, src/lib.rs:321-331; c2r: before the inverse,
    :506-523; dct: before, :688-741) around the unnormalized transform."""
    from ndrustfft_tpu import nddct2 as _dct2
    from ndrustfft_tpu import ndifft as _ifft
    from ndrustfft_tpu import ndifft_r2c as _ic2r
    from ndrustfft_tpu.api import _jitted

    n = 128
    rng = np.random.default_rng(1)
    xc = (rng.standard_normal((2, n, 16))
          + 1j * rng.standard_normal((2, n, 16))).astype(np.complex64)
    xr = rng.standard_normal((2, n, 16)).astype(np.float32)
    sp = (rng.standard_normal((2, n // 2 + 1, 16))
          + 1j * rng.standard_normal((2, n // 2 + 1, 16))
          ).astype(np.complex64)
    fn = lambda v: 3.0 * v + 0.1 * v * v  # noqa: E731 — nonlinear on purpose
    cn = Normalization.custom(fn)
    old = config.debug_plan_log
    try:
        config.debug_plan_log = True
        _jitted.cache_clear()
        got_i = np.asarray(_ifft(jnp.asarray(xc),
                                 FftHandler(n).normalization(cn), axis=1))
        got_c = np.asarray(_ic2r(jnp.asarray(sp),
                                 R2cFftHandler(n).normalization(cn), axis=1))
        got_d = np.asarray(_dct2(jnp.asarray(xr),
                                 DctHandler(n).normalization(cn), axis=1))
        err = capsys.readouterr().err
    finally:
        config.debug_plan_log = old
        _jitted.cache_clear()
    # every custom-normalized call dispatched to the engine core
    assert "ifft n=128 axis=1 -> engine-lane-last+moveaxis" in err, err
    assert "c2r n=128 axis=1 -> engine-c2r+moveaxis" in err, err
    assert "dct2 n=128 axis=1 -> engine-dct+moveaxis" in err, err
    # semantics at the reference's exact application points
    unnorm = np.fft.ifft(xc, axis=1) * n
    want_i = 3.0 * unnorm + 0.1 * unnorm * unnorm
    assert np.abs(got_i - want_i).max() / np.abs(want_i).max() < 1e-4
    spn = 3.0 * sp + 0.1 * sp * sp          # custom norm BEFORE the inverse
    spn[:, 0, :] = spn[:, 0, :].real        # then DC/Nyquist imag zeroing
    spn[:, -1, :] = spn[:, -1, :].real
    want_c = np.fft.irfft(spn, n=n, axis=1) * n   # unnormalized inverse
    assert np.abs(got_c - want_c).max() / np.abs(want_c).max() < 1e-4
    import scipy.fft as sfft

    want_d = sfft.dct((3.0 * xr + 0.1 * xr * xr).astype(np.float64),
                      type=2, axis=1) / 2  # rustdct convention = scipy/2
    assert np.abs(got_d - want_d).max() / np.abs(want_d).max() < 1e-4


def test_dct4_kernel_routes_beyond_dense_cap(capsys):
    """DCT-IV at n=2048 and at n=2018 (half length 1009, a prime whose
    half-length C2C plans as Bluestein) on the middle axis; DST-IV rides
    the same lowering via its flip/sign conjugation."""
    from ndrustfft_tpu import nddct4 as _dct4
    from ndrustfft_tpu import nddst4 as _dst4
    from ndrustfft_tpu.api import _jitted

    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 2048, 16)).astype(np.float32)
    xb = rng.standard_normal((1, 2018, 16)).astype(np.float32)
    old = config.debug_plan_log
    try:
        config.debug_plan_log = True
        _jitted.cache_clear()
        got4 = np.asarray(_dct4(jnp.asarray(x), DctHandler(2048), axis=1))
        gots = np.asarray(_dst4(jnp.asarray(x), DstHandler(2048), axis=1))
        gotb = np.asarray(_dct4(jnp.asarray(xb), DctHandler(2018), axis=1))
        err = capsys.readouterr().err
    finally:
        config.debug_plan_log = old
        _jitted.cache_clear()
    assert "dct4 n=2048 axis=1 -> engine-dct+moveaxis" in err, err
    assert "dct4 n=2018 axis=1 -> engine-dct+moveaxis" in err, err
    ref4 = sfft.dct(x.astype(np.float64), type=4, axis=1)
    assert np.abs(got4 - ref4).max() / np.abs(ref4).max() < 1e-4
    refs = sfft.dst(x.astype(np.float64), type=4, axis=1)
    assert np.abs(gots - refs).max() / np.abs(refs).max() < 1e-4
    refb = sfft.dct(xb.astype(np.float64), type=4, axis=1)
    assert np.abs(gotb - refb).max() / np.abs(refb).max() < 1e-4


def test_generic_kernel_compile_pathology_gate():
    """Bluestein plans choose a 3-smooth chirp length M that is a multiple
    of 128 above 256 (plan.blue_sub_len), so the two length-M sub-FFTs'
    stage matmuls run on whole 128-wide tiles; below that the FLOP-minimal
    3-smooth choice stands."""
    from ndrustfft_tpu.plan import blue_sub_len, get_c2c_plan

    for n, want_M in [(2049, 4608), (683, 1536), (4099, 9216)]:
        p = get_c2c_plan(n, -1)
        assert p.kind == "bluestein" and p.M == want_M == blue_sub_len(n)
        assert p.M % 128 == 0
    # FLOP-minimal choices stand when already aligned or small
    assert blue_sub_len(509) == 1024
    assert blue_sub_len(1021) == 2048
    assert blue_sub_len(127) == 256
    assert blue_sub_len(7) == 16
