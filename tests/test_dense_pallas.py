"""Fused dense GPU sweep == XLA dense sweep (interpret mode on the CPU).

The kernel (ops/dense_pallas.py, Pallas on the Triton route) runs here
through the Pallas interpreter at small tiles; tests/test_dense_gpu.py
runs the compiled kernel on a card.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from conftest import make_synthetic
from hgaprec_jax.data.device import build_device_data
from hgaprec_jax.ops.dense_pallas import (MAX_KP, fused_dense_sweep,
                                          kernel_width)
from hgaprec_jax.ops.sweep import Kernels, sweep_dense


@pytest.mark.parametrize("n,m,k,pad", [(40, 30, 3, 16), (70, 33, 5, 16),
                                       (40, 30, 3, 64)])  # Y wider than M
def test_fused_matches_xla_dense(rng, n, m, k, pad):
    store, _, _ = make_synthetic(rng, n=n, m=m, density=0.3)
    data = build_device_data(store, pad_multiple=pad)
    elog_a = rng.normal(size=(store.n, k)).astype(np.float32) * 0.3
    elog_b = rng.normal(size=(store.m, k)).astype(np.float32) * 0.3
    ja, jb = jnp.asarray(elog_a), jnp.asarray(elog_b)

    ref = sweep_dense(ja, jb, None, None, data.dense_y,
                      item_block=16, user_block=16)
    raw_a, raw_b = fused_dense_sweep(jnp.exp(ja), jnp.exp(jb), data.dense_y,
                                     tile_u=8, tile_c=16, interpret=True)
    acc_a = np.asarray(jnp.exp(ja) * raw_a)
    acc_b = np.asarray(jnp.exp(jb) * raw_b)
    np.testing.assert_allclose(acc_a, np.asarray(ref.acc_a),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(acc_b, np.asarray(ref.acc_b),
                               rtol=2e-4, atol=1e-5)


def test_kernel_width_gate():
    """Rows of K factors plus the two bias columns, padded to a power of
    two; K = 100 with biases still fits the kernel's registers."""
    assert kernel_width(100, False) == kernel_width(100, True) == 128
    assert kernel_width(126, True) == MAX_KP
    assert kernel_width(127, True) > MAX_KP
    assert kernel_width(3, False) == 16     # Triton's smallest dot side


def _force_fused(monkeypatch):
    """Route every dense block through the fused kernel, interpreted."""
    import hgaprec_jax.ops.sweep as sw
    monkeypatch.setattr(sw, "select_kernels",
                        lambda *a, **kw: Kernels("fused", None))
    monkeypatch.setattr(sw, "fused_dense_sweep", functools.partial(
        fused_dense_sweep, tile_u=8, tile_c=16, interpret=True))


@pytest.mark.parametrize("variant", ["bpf", "hpf"])
def test_step_parity_dense_pallas(rng, variant, monkeypatch):
    """cavi_step with the fused kernel == cavi_step with the XLA path."""
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.models.state import init_state
    from hgaprec_jax.models.step import cavi_step

    store, _, _ = make_synthetic(rng, n=24, m=18, density=0.35)
    data = build_device_data(store, pad_multiple=16)
    cfg = ModelConfig(n=store.n, m=store.m, k=3, variant=variant,
                      sweep="dense")
    s_x = init_state(cfg, seed=7)
    for _ in range(3):
        s_x = cavi_step(s_x, data, cfg)
    _force_fused(monkeypatch)
    s_p = init_state(cfg, seed=7)
    for _ in range(3):
        s_p = cavi_step(s_p, data, cfg)
    np.testing.assert_allclose(np.asarray(s_p.theta.e),
                               np.asarray(s_x.theta.e), rtol=5e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(s_p.beta.e),
                               np.asarray(s_x.beta.e), rtol=5e-4,
                               atol=1e-6)


def test_fused_bias_matches_xla_dense(rng):
    """Pallas kernel with bias slots == XLA dense sweep with bias."""
    store, _, _ = make_synthetic(rng, n=45, m=29, density=0.3)
    data = build_device_data(store, pad_multiple=16)
    k = 4
    elog_a = rng.normal(size=(store.n, k)).astype(np.float32) * 0.3
    elog_b = rng.normal(size=(store.m, k)).astype(np.float32) * 0.3
    elog_ba = rng.normal(size=(store.n,)).astype(np.float32) * 0.3
    elog_bb = rng.normal(size=(store.m,)).astype(np.float32) * 0.3
    ja, jb = jnp.asarray(elog_a), jnp.asarray(elog_b)
    jba, jbb = jnp.asarray(elog_ba), jnp.asarray(elog_bb)

    ref = sweep_dense(ja, jb, jba, jbb, data.dense_y,
                      item_block=16, user_block=16)
    raw = fused_dense_sweep(jnp.exp(ja), jnp.exp(jb), data.dense_y,
                            jnp.exp(jba), jnp.exp(jbb),
                            tile_u=8, tile_c=16, interpret=True)
    np.testing.assert_allclose(np.asarray(jnp.exp(ja) * raw[0]),
                               np.asarray(ref.acc_a), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jnp.exp(jb) * raw[1]),
                               np.asarray(ref.acc_b), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jnp.exp(jba) * raw[2]),
                               np.asarray(ref.acc_bias_a), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(jnp.exp(jbb) * raw[3]),
                               np.asarray(ref.acc_bias_b), rtol=2e-4,
                               atol=1e-5)


def test_fused_bias_bf16_close_to_f32(rng):
    """Bias variant, bf16 vs f32 (ADVICE r4: in bf16 mode the bias
    expectations enter the score through the matmul and the bias
    statistics rowsum/colsum(w) are reduced in bf16 — pin the accepted
    error bound for the serving config)."""
    store, _, _ = make_synthetic(rng, n=45, m=29, density=0.3)
    data = build_device_data(store, pad_multiple=16)
    k = 4
    args = [jnp.exp(jnp.asarray(
        rng.normal(size=s).astype(np.float32) * 0.3))
        for s in ((store.n, k), (store.m, k), (store.n,), (store.m,))]
    f32 = fused_dense_sweep(*args[:2], data.dense_y, *args[2:],
                            tile_u=8, tile_c=16, interpret=True)
    bf = fused_dense_sweep(*args[:2], data.dense_y, *args[2:],
                           bf16=True, tile_u=8, tile_c=16, interpret=True)
    for r, g in zip(f32, bf):
        r, g = np.asarray(r), np.asarray(g)
        denom = np.maximum(np.abs(r), 1e-3)
        assert np.max(np.abs(g - r) / denom) < 2e-2


def test_row_padded_y(rng):
    """dense_y rows padded past N at build time (odd-N fix): both the
    Pallas kernel and the XLA dense path must slice back to N."""
    store, _, _ = make_synthetic(rng, n=37, m=22, density=0.3)  # odd N
    data = build_device_data(store, pad_multiple=16)
    k = 3
    elog_a = rng.normal(size=(store.n, k)).astype(np.float32) * 0.3
    elog_b = rng.normal(size=(store.m, k)).astype(np.float32) * 0.3
    ja, jb = jnp.asarray(elog_a), jnp.asarray(elog_b)
    y_padded = jnp.pad(data.dense_y, ((0, 11), (0, 0)))  # rows > N

    ref = sweep_dense(ja, jb, None, None, data.dense_y,
                      item_block=16, user_block=16)
    got = sweep_dense(ja, jb, None, None, y_padded,
                      item_block=16, user_block=16)
    np.testing.assert_allclose(np.asarray(got.acc_a), np.asarray(ref.acc_a),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.acc_b), np.asarray(ref.acc_b),
                               rtol=2e-4, atol=1e-5)
    raw_a, raw_b = fused_dense_sweep(jnp.exp(ja), jnp.exp(jb), y_padded,
                                     tile_u=8, tile_c=16, interpret=True)
    np.testing.assert_allclose(np.asarray(jnp.exp(ja) * raw_a),
                               np.asarray(ref.acc_a), rtol=2e-4, atol=1e-5)


def test_odd_n_tiling_not_degenerate():
    """Netflix's odd N (480,189): build-time row padding must give the
    XLA dense path a real tile height, not 1-row tiles."""
    from hgaprec_jax.ops.sweep import _user_block_of
    assert _user_block_of(480189, 16384) == 1          # the raw landmine
    n_store = -(-480189 // 512) * 512                  # build-time padding
    assert _user_block_of(n_store, 16384) >= 512       # fixed


def test_u16_view_byte_order():
    """The kernel reads Y two counts at a time: the low byte of each u16
    word is the even column, the high byte the odd one."""
    from hgaprec_jax.ops.dense_pallas import _planes
    y = jnp.asarray(np.arange(24, dtype=np.uint8).reshape(3, 8))
    v = jax.lax.bitcast_convert_type(y.reshape(3, 4, 2), jnp.uint16)
    even, odd = _planes(v)
    np.testing.assert_array_equal(np.asarray(even), np.asarray(y[:, 0::2]))
    np.testing.assert_array_equal(np.asarray(odd), np.asarray(y[:, 1::2]))


def test_fused_rejects_float_counts(rng):
    a = jnp.ones((8, 3))
    with pytest.raises(TypeError, match="uint8"):
        fused_dense_sweep(a, a, jnp.ones((8, 8), jnp.float32),
                          tile_u=8, tile_c=16, interpret=True)


@pytest.mark.parametrize("bias", [False, True])
def test_fused_vs_f64_reference(rng, bias):
    """Odd N, M off the tile, counts up to 255, against f64 NumPy."""
    n, m, k = 53, 41, 7
    y = np.where(rng.random((n, m)) < 0.3, rng.integers(1, 256, (n, m)), 0)
    a = rng.random((n, k)) + 0.1
    b = rng.random((m, k)) + 0.1
    ba, bb = rng.random(n) + 0.05, rng.random(m) + 0.05
    s = a @ b.T + ((ba[:, None] + bb[None, :]) if bias else 0.0)
    w = np.where(y > 0, y / s, 0.0)
    ref = [w @ b, w.T @ a] + ([w.sum(1), w.sum(0)] if bias else [])
    j = functools.partial(jnp.asarray, dtype=jnp.float32)
    got = fused_dense_sweep(j(a), j(b), jnp.asarray(y, jnp.uint8),
                            *((j(ba), j(bb)) if bias else ()),
                            tile_u=8, tile_c=16, interpret=True)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), r, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_hybrid_head_through_fused_kernel(rng, bias, monkeypatch):
    """The hybrid head block through the fused kernel == the segment
    sweep over the whole stream."""
    from hgaprec_jax.ops.sweep import sweep, sweep_segment
    store, _, _ = make_synthetic(rng, n=47, m=35, density=0.3)
    k = 4
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.3)
    ea, eb = f(store.n, k), f(store.m, k)
    eba, ebb = (f(store.n), f(store.m)) if bias else (None, None)
    data = build_device_data(store, pad_multiple=16, dense=False,
                             hybrid_head_items=12)
    ref = sweep_segment(ea, eb, eba, ebb, data)
    import hgaprec_jax.ops.sweep as sw
    monkeypatch.setattr(sw, "select_kernels",
                        lambda *a, **kw: Kernels("fused", "mxu"))
    monkeypatch.setattr(sw, "fused_dense_sweep", functools.partial(
        fused_dense_sweep, tile_u=8, tile_c=16, interpret=True))
    got = sweep(ea, eb, eba, ebb, data, "hybrid")
    for g, r in zip(got, ref):
        if r is not None:
            np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                       rtol=2e-4, atol=1e-5)
