"""C2C FFT tests: reference fixture parity + live numpy oracles.

Mirrors the reference's unit-test strategy (src/lib.rs:847-1407): the shared
6x6 fixture matrix, golden values regenerated live from numpy (instead of
hard-coded to 3 decimals), roundtrip identities, F-layout coverage, and
serial==par equivalence — widened with f32+f64, 1-4D arrays, every axis, and
a size sweep hitting pow2 / smooth / odd / prime (Bluestein) planner paths.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from ndrustfft_tpu import FftHandler, Normalization, ndfft, ndfft_par, ndifft, ndifft_par

# the reference's 6x6 fixture (src/lib.rs:880-889): v[i,j] = i*6+j as f64


def fixture_matrix(n=6):
    return np.arange(n * n, dtype=np.float64).reshape(n, n)


def complex_matrix(n=6):
    m = fixture_matrix(n)
    return m + 1j * m


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype,rtol", [(np.complex64, 1e-5), (np.complex128, 1e-12)])
def test_fft_2d_golden(axis, dtype, rtol):
    v = complex_matrix().astype(dtype)
    h = FftHandler(6)
    got = np.asarray(ndfft(jnp.asarray(v), h, axis=axis))
    ref = np.fft.fft(v, axis=axis)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("axis", [0, 1])
def test_fft_ifft_roundtrip(axis):
    v = complex_matrix()
    h = FftHandler(6)
    vhat = ndfft(jnp.asarray(v), h, axis=axis)
    back = np.asarray(ndifft(vhat, h, axis=axis))
    np.testing.assert_allclose(back, v, rtol=1e-12, atol=1e-12)


def test_transposed_view_semantics():
    # the reference's F-layout test (src/lib.rs:996-1040) pins that layout
    # never changes VALUES; JAX manages layouts internally, so the honest
    # analog is: a traced transpose view feeding the transform (inside one
    # jit, where no materialization forces a canonical layout) matches the
    # transform of the materialized transpose.
    import jax

    v = complex_matrix()
    h = FftHandler(6)

    @jax.jit
    def on_view(x):
        return ndfft(x.T, h, axis=0)   # transform the transposed VIEW

    got = np.asarray(on_view(jnp.asarray(v)))
    ref = np.fft.fft(v.T, axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 12, 16, 27, 32, 100, 101,
                               127, 128, 250, 263, 264, 509, 512, 1024])
def test_fft_size_sweep(n):
    # pow2 / {2,3,5}-smooth / odd / prime (127, 263, 509 exercise Bluestein
    # via the planner's max-radix policy for primes > 128: 263, 509).
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    h = FftHandler(n)
    got = np.asarray(ndfft(jnp.asarray(x), h, axis=1))
    ref = np.fft.fft(x, axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11 * np.abs(ref).max())
    back = np.asarray(ndifft(jnp.asarray(got), h, axis=1))
    np.testing.assert_allclose(back, x, rtol=1e-11, atol=1e-11 * np.abs(x).max())


@pytest.mark.parametrize("shape,axis", [
    ((7,), 0),
    ((4, 7), 0), ((4, 7), 1),
    ((3, 4, 5), 0), ((3, 4, 5), 1), ((3, 4, 5), 2),
    ((2, 3, 4, 5), 0), ((2, 3, 4, 5), 1), ((2, 3, 4, 5), 2), ((2, 3, 4, 5), 3),
])
def test_fft_every_axis_1_to_4d(shape, axis):
    rng = np.random.default_rng(42)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    h = FftHandler(shape[axis])
    got = np.asarray(ndfft(jnp.asarray(x), h, axis=axis))
    ref = np.fft.fft(x, axis=axis)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_fft_par_equivalence():
    # serial == par goldens (reference src/lib.rs:949-994)
    v = complex_matrix()
    h = FftHandler(6)
    a = np.asarray(ndfft(jnp.asarray(v), h, axis=0))
    b = np.asarray(ndfft_par(jnp.asarray(v), h, axis=0))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(ndifft(jnp.asarray(v), h, axis=0))
    d = np.asarray(ndifft_par(jnp.asarray(v), h, axis=0))
    np.testing.assert_array_equal(c, d)


# --- normalization semantics (examples/fft_norm.rs) ------------------------


def test_norm_default_roundtrip():
    v = np.array([1 + 1j, 2 + 2j, 3 + 3j])
    h = FftHandler(3).normalization(Normalization.DEFAULT)
    out = np.asarray(ndifft(ndfft(jnp.asarray(v), h, 0), h, 0))
    np.testing.assert_allclose(out, v, rtol=1e-12)


def test_norm_none_roundtrip_times_n():
    v = np.array([1 + 1j, 2 + 2j, 3 + 3j])
    h = FftHandler(3).normalization(Normalization.NONE)
    out = np.asarray(ndifft(ndfft(jnp.asarray(v), h, 0), h, 0))
    np.testing.assert_allclose(out, 3 * v, rtol=1e-12)


def test_norm_custom():
    # my_norm = 2/len (examples/fft_norm.rs:36-41) -> roundtrip gives 2*v
    v = np.array([1 + 1j, 2 + 2j, 3 + 3j])
    h = FftHandler(3).normalization(
        Normalization.custom(lambda d: d * (2.0 / d.shape[-1]))
    )
    out = np.asarray(ndifft(ndfft(jnp.asarray(v), h, 0), h, 0))
    np.testing.assert_allclose(out, 2 * v, rtol=1e-12)


def test_forward_never_normalized():
    # fft_lane applies NO normalization for any policy (src/lib.rs:313-318)
    v = complex_matrix()
    ref = np.fft.fft(v, axis=0)
    for norm in [Normalization.DEFAULT, Normalization.NONE,
                 Normalization.custom(lambda d: d * 0.0)]:
        h = FftHandler(6).normalization(norm)
        got = np.asarray(ndfft(jnp.asarray(v), h, axis=0))
        np.testing.assert_allclose(got, ref, rtol=1e-12)


# --- error parity -----------------------------------------------------------


def test_size_mismatch_message():
    h = FftHandler(5)
    with pytest.raises(ValueError, match=r"Size mismatch in fft, got 6 expected 5"):
        ndfft(jnp.zeros((6,), jnp.complex128), h, axis=0)


def test_axis_out_of_bounds():
    with pytest.raises(ValueError, match="axis"):
        ndfft(jnp.zeros((4, 4), jnp.complex128), FftHandler(4), axis=2)


def test_auto_handler():
    v = complex_matrix()
    got = np.asarray(ndfft(jnp.asarray(v), axis=1))
    np.testing.assert_allclose(got, np.fft.fft(v, axis=1), rtol=1e-12)


def test_inside_user_jit():
    import jax

    v = complex_matrix()
    h = FftHandler(6)

    @jax.jit
    def f(x):
        return ndifft(ndfft(x, h, 0), h, 0)

    np.testing.assert_allclose(np.asarray(f(jnp.asarray(v))), v, rtol=1e-12, atol=1e-12)


def test_grad_through_fft():
    # functional transforms must be differentiable (a capability the Rust
    # reference cannot have — pinned here as a framework feature).
    import jax

    h = FftHandler(8)

    def loss(x):
        return jnp.sum(jnp.abs(ndfft(x, h, 0)) ** 2)

    x = jnp.asarray(np.random.default_rng(0).standard_normal(8) + 0j)
    g = jax.grad(loss)(x)
    # Parseval: d/dx sum|FFT x|^2 = 2n x (for complex grad convention, conj)
    np.testing.assert_allclose(np.asarray(g), 8 * 2 * np.asarray(x).conj(), rtol=1e-10)


def test_axis0_custom_norm_lane_contract():
    # the axis-0 fast path must still hand custom norm fns a lane-last view
    v = complex_matrix()
    seen_shapes = []

    def fn(d):
        seen_shapes.append(d.shape)
        return d * (1.0 / d.shape[-1])

    h = FftHandler(6).normalization(Normalization.custom(fn))
    out = np.asarray(ndifft(ndfft(jnp.asarray(v), h, axis=0), h, axis=0))
    np.testing.assert_allclose(out, v, rtol=1e-12, atol=1e-12)
    assert all(s[-1] == 6 for s in seen_shapes)


def test_axis0_matches_lastaxis_path():
    # the two engine layouts must agree on identical data
    rng = np.random.default_rng(11)
    v = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    h = FftHandler(16)
    a = np.asarray(ndfft(jnp.asarray(v), h, axis=0))
    b = np.asarray(ndfft(jnp.asarray(v.T), h, axis=1)).T
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize("strategy,n", [("moveaxis", 64), ("einsum", 64),
                                        ("einsum", 96)])
def test_axis0_strategies_agree(strategy, n):
    # both axis-0 execution strategies must produce the same result, on a
    # power of two and on a mixed-radix size
    from ndrustfft_tpu import config
    from ndrustfft_tpu.api import _jitted

    rng = np.random.default_rng(13)
    v = (rng.standard_normal((n, 16)) + 1j * rng.standard_normal((n, 16))
         ).astype(np.complex64)
    old_s = config.axis0_strategy
    try:
        config.axis0_strategy = strategy
        _jitted.cache_clear()
        got = np.asarray(ndfft(jnp.asarray(v), FftHandler(n), axis=0))
    finally:
        config.axis0_strategy = old_s
        _jitted.cache_clear()
    ref = np.fft.fft(v, axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_sub_f32_inputs_promoted():
    # bf16/f16 real inputs are promoted to f32 (dtype policy)
    x = np.random.default_rng(20).standard_normal((4, 16)).astype(np.float32)
    from ndrustfft_tpu import ndfft_r2c

    got16 = ndfft_r2c(jnp.asarray(x, dtype=jnp.bfloat16), axis=1)
    assert got16.dtype == jnp.complex64
    ref = np.fft.rfft(x.astype(np.float64), axis=1)
    # bf16 input data only has ~3 decimal digits; loose tolerance
    np.testing.assert_allclose(np.asarray(got16), ref, rtol=0.05,
                               atol=0.05 * np.abs(ref).max())


def test_bluestein_three_smooth_padding():
    from ndrustfft_tpu.plan import get_c2c_plan, next_smooth

    assert next_smooth(13) == 16 or next_smooth(13) == 18
    for n, expect in [(7, 8), (17, 18), (33, 36), (100, 108)]:
        assert next_smooth(n) == expect, (n, next_smooth(n))
    p = get_c2c_plan(509, -1)
    assert p.kind == "bluestein" and p.M >= 2 * 509 - 1
    x = np.random.default_rng(21).standard_normal(509) + 0j
    got = np.asarray(ndfft(jnp.asarray(x), FftHandler(509), 0))
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-10,
                               atol=1e-10 * np.abs(np.fft.fft(x)).max())


def test_vmap_equivalence():
    # serial == vmap (SURVEY §4 test plan): mapping over a batch dim gives
    # the same values as the batched call
    import jax

    rng = np.random.default_rng(30)
    x = rng.standard_normal((5, 4, 12)) + 1j * rng.standard_normal((5, 4, 12))
    h = FftHandler(12)
    direct = np.asarray(ndfft(jnp.asarray(x), h, axis=2))
    mapped = np.asarray(jax.vmap(lambda v: ndfft(v, h, axis=1))(jnp.asarray(x)))
    np.testing.assert_allclose(mapped, direct, rtol=1e-12,
                               atol=1e-12 * np.abs(direct).max())


def test_vmap_equivalence_bluestein():
    # serial == vmap through the chirp-z path (prime n: pad, two sub-FFTs,
    # pointwise H — all batch-polymorphic, but never pinned under vmap)
    import jax

    from ndrustfft_tpu.plan import get_c2c_plan

    n = 149  # smallest prime beyond the dense-radix cap -> chirp-z plan
    assert get_c2c_plan(n, -1).kind == "bluestein"
    rng = np.random.default_rng(33)
    x = rng.standard_normal((5, 4, n)) + 1j * rng.standard_normal((5, 4, n))
    h = FftHandler(n)
    direct = np.asarray(ndfft(jnp.asarray(x), h, axis=2))
    mapped = np.asarray(jax.vmap(lambda v: ndfft(v, h, axis=1))(jnp.asarray(x)))
    np.testing.assert_allclose(mapped, direct, rtol=1e-12,
                               atol=1e-12 * np.abs(direct).max())
    np.testing.assert_allclose(direct, np.fft.fft(x, axis=2), rtol=1e-10,
                               atol=1e-10 * np.abs(direct).max())


def test_grad_through_r2c_pipeline():
    import jax

    from ndrustfft_tpu import R2cFftHandler, ndfft_r2c

    h = R2cFftHandler(16)

    def loss(x):
        return jnp.sum(jnp.abs(ndfft_r2c(x, h, 0)) ** 2)

    x = jnp.asarray(np.random.default_rng(31).standard_normal(16))
    g = jax.grad(loss)(x)
    # finite-difference check on one coordinate
    eps = 1e-6
    e0 = np.zeros(16); e0[3] = eps
    fd = (float(loss(x + e0)) - float(loss(x - e0))) / (2 * eps)
    np.testing.assert_allclose(float(g[3]), fd, rtol=1e-4)


def test_long_transform_1m_points():
    # single long transform stays on-chip (SURVEY §5 long-context analog):
    # n = 2^20 through the 3-level engine recursion
    n = 1 << 20
    rng = np.random.default_rng(50)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    h = FftHandler(n)
    got = np.asarray(ndfft(jnp.asarray(x), h, axis=0))
    ref = np.fft.fft(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    back = np.asarray(ndifft(jnp.asarray(got), h, axis=0))
    assert np.abs(back - x).max() < 1e-2  # f32 roundtrip at n=2^20


def test_long_transform_fourstep_xla_transpose_leg():
    # a long mixed-radix transform (no power-of-two split beyond 2^8): the
    # engine recursion over radix-3 stages stays at f32 accuracy
    n = 559872  # 2^8 * 3^7
    rng = np.random.default_rng(52)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    h = FftHandler(n)
    got = np.asarray(ndfft(jnp.asarray(x), h, axis=0))
    ref = np.fft.fft(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_huge_prime_bluestein_over_fourstep():
    # prime n whose chirp length M = next_smooth(2n-1) is itself a long
    # transform: the Bluestein sub-FFTs recurse through the multi-level
    # engine (rustfft any-n parity at ANY magnitude,
    # /root/reference/src/lib.rs:295-297)
    from ndrustfft_tpu.plan import get_c2c_plan

    n = 100003  # prime
    plan = get_c2c_plan(n, -1)
    assert plan.kind == "bluestein" and plan.M > 1 << 16, (plan.kind, plan.M)
    rng = np.random.default_rng(53)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    h = FftHandler(n)
    got = np.asarray(ndfft(jnp.asarray(x), h, axis=0))
    ref = np.fft.fft(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    back = np.asarray(ndifft(jnp.asarray(got), h, axis=0))
    assert np.abs(back - x).max() < 1e-4


def test_norm_scalar():
    # Normalization.scalar(c): the fused policy == custom(v -> v*c)
    v = np.array([1 + 1j, 2 + 2j, 3 + 3j])
    h = FftHandler(3).normalization(Normalization.scalar(2.0 / 3.0))
    out = np.asarray(ndifft(ndfft(jnp.asarray(v), h, 0), h, 0))
    np.testing.assert_allclose(out, 2 * v, rtol=1e-12)
    # forward stays unnormalized for scalar policies too
    got = np.asarray(ndfft(jnp.asarray(v), h, 0))
    np.testing.assert_allclose(got, np.fft.fft(v), rtol=1e-12)


def test_norm_scalar_fused_kernel_paths():
    # the scalar folds into the transform on every dispatch path: compare
    # the fused result against an explicit multiply for minor / middle /
    # leading axes
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((128, 128, 128))
         + 1j * rng.standard_normal((128, 128, 128))).astype(np.complex64)
    c = 0.37
    h = FftHandler(128).normalization(Normalization.scalar(c))
    h_none = FftHandler(128).normalization(Normalization.NONE)
    for axis in (0, 1, 2):
        got = np.asarray(ndifft(jnp.asarray(x), h, axis=axis))
        ref = c * np.asarray(ndifft(jnp.asarray(x), h_none, axis=axis))
        # f32: folding c into the last stage rounds differently from an
        # exact post-multiply (~1e-6 rel)
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-4)


def test_norm_default_fused_matches_explicit():
    # ifft's default 1/n is folded into the last stage; it must equal
    # the explicit post-multiply to rounding error
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 384))
         + 1j * rng.standard_normal((3, 384)))
    h = FftHandler(384)
    h_none = FftHandler(384).normalization(Normalization.NONE)
    got = np.asarray(ndifft(jnp.asarray(x), h, axis=1))
    ref = np.asarray(ndifft(jnp.asarray(x), h_none, axis=1)) / 384.0
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
