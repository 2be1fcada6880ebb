"""Sweep-path equivalence: dense MXU path == segment path == naive loop."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import make_synthetic
from hgaprec_jax.data.device import build_device_data
from hgaprec_jax.ops.sweep import sweep, sweep_dense, sweep_segment


def naive_sweep(elog_a, elog_b, bias_a, bias_b, u, i, y):
    """Literal re-statement of the reference loop (hgaprec.cc:928-941)."""
    n, k = elog_a.shape
    m = elog_b.shape[0]
    acc_a = np.zeros((n, k))
    acc_b = np.zeros((m, k))
    acc_ba = np.zeros(n)
    acc_bb = np.zeros(m)
    for a_idx, b_idx, yy in zip(u, i, y):
        logits = elog_a[a_idx] + elog_b[b_idx]
        if bias_a is not None:
            logits = np.concatenate([logits, [bias_a[a_idx]],
                                     [bias_b[b_idx]]])
        ex = np.exp(logits - logits.max())
        phi = ex / ex.sum()
        phi = phi * yy
        acc_a[a_idx] += phi[:k]
        acc_b[b_idx] += phi[:k]
        if bias_a is not None:
            acc_ba[a_idx] += phi[k]
            acc_bb[b_idx] += phi[k + 1]
    return acc_a, acc_b, acc_ba, acc_bb


def _setup(rng, bias, n=17, m=13, k=5, nnz=60):
    from hgaprec_jax.data.ratings import RatingsStore
    store = RatingsStore(n, m)
    seen = set()
    while len(seen) < nnz:
        seen.add((int(rng.integers(0, n)), int(rng.integers(0, m))))
    u, i = np.array(sorted(seen)).T
    y = rng.integers(1, 6, size=u.size)
    store.add_training(u, i, y)
    store.finalize()
    data = build_device_data(store, pad_multiple=64)
    elog_a = rng.normal(size=(store.n, k)) * 0.5 - 1.0
    elog_b = rng.normal(size=(store.m, k)) * 0.5 - 1.0
    ba = rng.normal(size=store.n) - 2.0 if bias else None
    bb = rng.normal(size=store.m) - 2.0 if bias else None
    return store, data, elog_a, elog_b, ba, bb


@pytest.mark.parametrize("bias", [False, True])
def test_paths_agree(rng, bias):
    store, data, elog_a, elog_b, ba, bb = _setup(rng, bias)
    ref = naive_sweep(elog_a, elog_b, ba, bb,
                      store.coo_u, store.coo_i, store.coo_y)

    j = lambda x: None if x is None else jnp.asarray(x, jnp.float32)
    seg = sweep_segment(j(elog_a), j(elog_b), j(ba), j(bb), data)
    np.testing.assert_allclose(np.asarray(seg.acc_a), ref[0], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(seg.acc_b), ref[1], rtol=2e-4,
                               atol=1e-5)

    den = sweep_dense(j(elog_a), j(elog_b), j(ba), j(bb), data.dense_y,
                      item_block=8)
    np.testing.assert_allclose(np.asarray(den.acc_a), ref[0], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(den.acc_b), ref[1], rtol=2e-4,
                               atol=1e-5)
    if bias:
        np.testing.assert_allclose(np.asarray(seg.acc_bias_a), ref[2],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(den.acc_bias_a), ref[2],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(seg.acc_bias_b), ref[3],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(den.acc_bias_b), ref[3],
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("bias", [False, True])
def test_user_blocked_dense_agrees(rng, bias):
    """rows > user_block: two-level streaming == naive loop."""
    store, data, elog_a, elog_b, ba, bb = _setup(rng, bias, n=32, m=13,
                                                 nnz=150)
    ref = naive_sweep(elog_a, elog_b, ba, bb,
                      store.coo_u, store.coo_i, store.coo_y)
    j = lambda x: None if x is None else jnp.asarray(x, jnp.float32)
    den = sweep_dense(j(elog_a), j(elog_b), j(ba), j(bb), data.dense_y,
                      item_block=8, user_block=8)
    np.testing.assert_allclose(np.asarray(den.acc_a), ref[0], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(den.acc_b), ref[1], rtol=2e-4,
                               atol=1e-5)
    if bias:
        np.testing.assert_allclose(np.asarray(den.acc_bias_a), ref[2],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(den.acc_bias_b), ref[3],
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("bias", [False, True])
def test_chunked_segment_agrees(rng, bias):
    """Streamed segment sweep == one-shot segment sweep."""
    from hgaprec_jax.ops.sweep import sweep_segment_chunked
    store, data, elog_a, elog_b, ba, bb = _setup(rng, bias, n=23, m=19,
                                                 nnz=130)
    j = lambda x: None if x is None else jnp.asarray(x, jnp.float32)
    one = sweep_segment(j(elog_a), j(elog_b), j(ba), j(bb), data)
    chunked = sweep_segment_chunked(j(elog_a), j(elog_b), j(ba), j(bb),
                                    data, chunk=48)
    np.testing.assert_allclose(np.asarray(chunked.acc_a),
                               np.asarray(one.acc_a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(chunked.acc_b),
                               np.asarray(one.acc_b), rtol=1e-5, atol=1e-6)
    if bias:
        np.testing.assert_allclose(np.asarray(chunked.acc_bias_a),
                                   np.asarray(one.acc_bias_a), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(chunked.acc_bias_b),
                                   np.asarray(one.acc_bias_b), rtol=1e-5,
                                   atol=1e-6)


def test_padding_contributes_nothing(rng):
    store, data, elog_a, elog_b, _, _ = _setup(rng, False)
    j = lambda x: jnp.asarray(x, jnp.float32)
    small = build_device_data(store, pad_multiple=64)
    big = build_device_data(store, pad_multiple=256)
    s1 = sweep_segment(j(elog_a), j(elog_b), None, None, small)
    s2 = sweep_segment(j(elog_a), j(elog_b), None, None, big)
    np.testing.assert_allclose(np.asarray(s1.acc_a), np.asarray(s2.acc_a),
                               rtol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_hybrid_matches_segment(rng, bias):
    """Head/tail hybrid sweep == pure segment sweep (same accumulators)."""
    from hgaprec_jax.data.device import build_device_data as bdd
    store, _, _ = make_synthetic(rng, n=47, m=35, density=0.3)
    k = 4
    elog_a = jnp.asarray(rng.normal(size=(store.n, k)).astype(np.float32)
                         * 0.3)
    elog_b = jnp.asarray(rng.normal(size=(store.m, k)).astype(np.float32)
                         * 0.3)
    eba = jnp.asarray(rng.normal(size=(store.n,)).astype(np.float32) * 0.3) \
        if bias else None
    ebb = jnp.asarray(rng.normal(size=(store.m,)).astype(np.float32) * 0.3) \
        if bias else None

    data_seg = bdd(store, pad_multiple=16, dense=False)
    ref = sweep_segment(elog_a, elog_b, eba, ebb, data_seg)

    data_h = bdd(store, pad_multiple=16, dense=False, hybrid_head_items=12)
    assert data_h.head_dense_y is not None
    assert data_h.head_items.shape[0] <= 12
    # tail must actually contain some nonzeros and exclude head items
    head_set = set(np.asarray(data_h.head_items).tolist())
    tails = np.asarray(data_h.i_ids_tail)[np.asarray(data_h.y_tail) > 0]
    assert tails.size > 0 and not head_set.intersection(tails.tolist())
    got = sweep(elog_a, elog_b, eba, ebb, data_h, "hybrid")

    np.testing.assert_allclose(np.asarray(got.acc_a), np.asarray(ref.acc_a),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.acc_b), np.asarray(ref.acc_b),
                               rtol=2e-4, atol=1e-5)
    if bias:
        np.testing.assert_allclose(np.asarray(got.acc_bias_a),
                                   np.asarray(ref.acc_bias_a),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(got.acc_bias_b),
                                   np.asarray(ref.acc_bias_b),
                                   rtol=2e-4, atol=1e-5)


def test_hybrid_step_matches_segment_step(rng):
    """cavi_step over hybrid data == cavi_step over segment data (HPF)."""
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.device import build_device_data as bdd
    from hgaprec_jax.models.state import init_state
    from hgaprec_jax.models.step import cavi_step
    store, _, _ = make_synthetic(rng, n=31, m=23, density=0.35)
    cfg_s = ModelConfig(n=store.n, m=store.m, k=3, variant="hpf",
                        sweep="segment")
    cfg_h = ModelConfig(n=store.n, m=store.m, k=3, variant="hpf",
                        sweep="hybrid")
    d_s = bdd(store, pad_multiple=16, dense=False)
    d_h = bdd(store, pad_multiple=16, dense=False, hybrid_head_items=8)
    s1 = init_state(cfg_s, seed=4)
    s2 = init_state(cfg_h, seed=4)
    for _ in range(3):
        s1 = cavi_step(s1, d_s, cfg_s)
        s2 = cavi_step(s2, d_h, cfg_h)
    np.testing.assert_allclose(np.asarray(s2.theta.e),
                               np.asarray(s1.theta.e), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(s2.beta.e),
                               np.asarray(s1.beta.e), rtol=2e-4, atol=1e-6)
