"""MXU tail sweep == segment sweep on the same COO stream.

The compact-id slab/one-hot-matmul formulation (ops/mxu_tail.py) must
reproduce the gather/segment-sum sweep (the correctness baseline pinned
to the reference loop, hgaprec.cc:928-941) exactly up to f32 summation
order.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hgaprec_jax.data.device import DeviceData, build_device_data
from hgaprec_jax.ops.mxu_tail import build_tail_compact, mxu_tail_sweep
from hgaprec_jax.ops.sweep import sweep_segment


def _coo(rng, n, m, nnz):
    """Deduplicated user-sorted COO with power-law-ish marginals."""
    u = rng.integers(0, n, nnz)
    i = np.minimum((m * rng.power(2.0, nnz)).astype(np.int64), m - 1)
    key = u * m + i
    order = np.argsort(key, kind="stable")
    key = key[order]
    keep = np.concatenate([[True], key[1:] != key[:-1]])
    u, i = u[order][keep], i[order][keep]
    y = rng.integers(1, 6, u.size).astype(np.float32)
    return u.astype(np.int32), i.astype(np.int32), y


def _segment_data(u, i, y, n, m):
    order = np.argsort(i, kind="stable").astype(np.int32)
    j = jnp.asarray
    return DeviceData(u_ids=j(u), i_ids=j(i), y=j(y),
                      item_order=j(order), i_ids_sorted=j(i[order]),
                      u_ids_by_item=j(u[order]), dense_y=None)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("chunk", [64, 256])
def test_matches_segment(bias, chunk):
    rng = np.random.default_rng(11)
    n, m, k = 173, 91, 9
    u, i, y = _coo(rng, n, m, 1200)
    elog_a = jnp.asarray(rng.normal(-0.5, 0.4, (n, k)), jnp.float32)
    elog_b = jnp.asarray(rng.normal(-0.5, 0.4, (m, k)), jnp.float32)
    eba = jnp.asarray(rng.normal(-1.0, 0.3, (n,)), jnp.float32) if bias \
        else None
    ebb = jnp.asarray(rng.normal(-1.0, 0.3, (m,)), jnp.float32) if bias \
        else None

    ref = sweep_segment(elog_a, elog_b, eba, ebb,
                        _segment_data(u, i, y, n, m))

    tc = build_tail_compact(u, i, y, pad_multiple=chunk)
    acc_a, acc_b, acc_ba, acc_bb = mxu_tail_sweep(
        jnp.exp(elog_a), jnp.exp(elog_b),
        jnp.exp(eba) if bias else None,
        jnp.exp(ebb) if bias else None, tc, chunk=chunk)

    np.testing.assert_allclose(acc_a, ref.acc_a, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(acc_b, ref.acc_b, rtol=2e-5, atol=1e-6)
    if bias:
        np.testing.assert_allclose(acc_ba, ref.acc_bias_a, rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(acc_bb, ref.acc_bias_b, rtol=2e-5,
                                   atol=1e-6)


def test_inactive_rows_zero():
    """Users/items absent from the stream get exactly-zero accumulators."""
    rng = np.random.default_rng(3)
    n, m, k = 50, 40, 4
    u = np.asarray([3, 3, 7, 20, 20, 20, 49], np.int32)
    i = np.asarray([1, 5, 2, 0, 9, 39, 9], np.int32)
    y = np.asarray([1, 2, 3, 1, 1, 4, 2], np.float32)
    elog_a = jnp.asarray(rng.normal(size=(n, k)), jnp.float32)
    elog_b = jnp.asarray(rng.normal(size=(m, k)), jnp.float32)
    tc = build_tail_compact(u, i, y, pad_multiple=16)
    acc_a, acc_b, _, _ = mxu_tail_sweep(jnp.exp(elog_a), jnp.exp(elog_b),
                                        None, None, tc, chunk=16)
    active_u = np.zeros(n, bool)
    active_u[u] = True
    active_i = np.zeros(m, bool)
    active_i[i] = True
    assert np.all(np.asarray(acc_a)[~active_u] == 0)
    assert np.all(np.asarray(acc_b)[~active_i] == 0)
    assert np.all(np.asarray(acc_a)[u].sum(1) > 0)

    ref = sweep_segment(elog_a, elog_b, None, None,
                        _segment_data(u, i, y, n, m))
    np.testing.assert_allclose(acc_a, ref.acc_a, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(acc_b, ref.acc_b, rtol=2e-5, atol=1e-6)


def test_hybrid_uses_compact_tail():
    """build_device_data builds the compact tail; hybrid sweep over it
    equals the pure segment sweep over the full stream."""
    from hgaprec_jax.data.ratings import RatingsStore
    from hgaprec_jax.ops.sweep import sweep

    rng = np.random.default_rng(5)
    k = 6
    u, i, y = _coo(rng, 96, 70, 900)
    store = RatingsStore(96, 70)
    store.add_training(u.tolist(), i.tolist(), y.tolist())
    store.finalize()
    n, m = store.n, store.m   # remapped seq-id space
    data = build_device_data(store, pad_multiple=64, dense=False,
                             hybrid_head_items=16)
    assert data.tail_compact is not None

    elog_a = jnp.asarray(rng.normal(-0.5, 0.4, (n, k)), jnp.float32)
    elog_b = jnp.asarray(rng.normal(-0.5, 0.4, (m, k)), jnp.float32)
    res = sweep(elog_a, elog_b, None, None, data, "hybrid")
    ref = sweep_segment(elog_a, elog_b, None, None,
                        _segment_data(store.coo_u, store.coo_i,
                                      store.coo_y.astype(np.float32),
                                      n, m))
    np.testing.assert_allclose(res.acc_a, ref.acc_a, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(res.acc_b, ref.acc_b, rtol=2e-4, atol=1e-5)


def _stream(rng, layout):
    """User-sorted, deduplicated COO. "identity": every user and item of
    the table appears, so compact ids equal the raw ids; "compact": few
    users and items, far apart, so compaction renumbers them."""
    if layout == "identity":
        n, m = 40, 30
        u = np.repeat(np.arange(n), 4)
        i = np.concatenate([rng.permutation(m)[:4] for _ in range(n)])
        i[:m] = np.arange(m)              # every item appears too
    else:
        n, m = 500, 400
        users = np.sort(rng.choice(n, 23, replace=False))
        items = rng.choice(m, 17, replace=False)
        u = np.repeat(users, 5)
        i = np.concatenate([rng.choice(items, 5, replace=False)
                            for _ in users])
    key = np.unique(u.astype(np.int64) * m + i)
    u, i = (key // m).astype(np.int32), (key % m).astype(np.int32)
    y = rng.integers(1, 6, u.size).astype(np.float32)
    return n, m, u, i, y


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("layout", ["identity", "compact"])
def test_matches_reference_impl(bias, layout):
    """The compact sweep against the f64 per-nonzero reference loop
    (tests/reference_impl.py phi_of, hgaprec.cc:928-941)."""
    import reference_impl as R

    rng = np.random.default_rng(29 + bias)
    n, m, u, i, y = _stream(rng, layout)
    k = 5
    ea = rng.normal(-0.5, 0.4, (n, k))
    eb = rng.normal(-0.5, 0.4, (m, k))
    eba = rng.normal(-1.0, 0.3, n) if bias else None
    ebb = rng.normal(-1.0, 0.3, m) if bias else None
    ref = [np.zeros((n, k)), np.zeros((m, k)), np.zeros(n), np.zeros(m)]
    for uu, ii, yy in zip(u, i, y):
        phi = yy * R.phi_of(ea, eb, uu, ii, eba, ebb)
        ref[0][uu] += phi[:k]
        ref[1][ii] += phi[:k]
        if bias:
            ref[2][uu] += phi[k]
            ref[3][ii] += phi[k + 1]

    tc = build_tail_compact(u, i, y, pad_multiple=64)
    if layout == "identity":
        np.testing.assert_array_equal(np.asarray(tc.users), np.arange(n))
    lin = lambda x: None if x is None else jnp.exp(jnp.asarray(x,
                                                               jnp.float32))
    got = mxu_tail_sweep(lin(ea), lin(eb), lin(eba), lin(ebb), tc, chunk=64)
    for g, r in zip(got, ref if bias else ref[:2]):
        np.testing.assert_allclose(np.asarray(g), r, rtol=2e-5, atol=1e-6)
    if not bias:
        assert got[2] is None and got[3] is None
