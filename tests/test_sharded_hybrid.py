"""Sharded hybrid head/tail == single-device hybrid (VERDICT r4 #1).

Before this round a `-devices N` run on an NYT/EchoNest-shaped catalog
silently fell back to the ~5x slower segment sweep: build_sharded_data
had no head/tail leaves. These tests pin the sharded hybrid layout —
per-shard head row blocks + per-shard padded TailCompact streams — to
the single-device hybrid trajectory on the 8-device CPU mesh, including
ragged shard populations (empty tails on some shards) and the bias
variant.
"""

import numpy as np
import pytest
import jax

from conftest import make_synthetic
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.data.device import build_device_data
from hgaprec_jax.models.state import init_state
from hgaprec_jax.models.step import _resolve_mode, make_step
from hgaprec_jax.parallel.sharded import build_sharded_run, make_mesh


def _cfg(store, **kw):
    base = dict(n=store.n, m=store.m, k=4, variant="hpf", sweep="hybrid",
                hybrid_head_items=8, dense_limit_bytes=64)
    base.update(kw)
    return ModelConfig(**base)


def _single(store, cfg, steps=3, seed=11):
    data = build_device_data(store, pad_multiple=128,
                             hybrid_head_items=cfg.hybrid_head_items,
                             dense_limit_bytes=cfg.dense_limit_bytes)
    assert data.dense_y is None and data.head_dense_y is not None
    assert _resolve_mode(cfg, data) == "hybrid"
    state = init_state(cfg, seed=seed)
    step = make_step(cfg)
    for _ in range(steps):
        state = step(state, data)
    return state


@pytest.mark.parametrize("variant,kw", [
    ("hpf", {}),
    ("bpf", {"bias": True}),
    ("bpf", {}),
])
def test_sharded_hybrid_matches_single(rng, variant, kw):
    assert len(jax.devices()) == 8
    store, _, _ = make_synthetic(rng, n=70, m=45, density=0.3)
    cfg = _cfg(store, variant=variant, **kw)
    state = _single(store, cfg)

    run = build_sharded_run(store, cfg, make_mesh(), seed=11,
                            pad_multiple=128)
    # the sharded builder built the hybrid leaves, not just COO
    assert run.data.head_dense_y is not None
    assert run.data.tail_compact is not None
    assert _resolve_mode(run.cfg, run.data) == "hybrid"
    for _ in range(3):
        run.step()
    got = run.unsharded_state()

    def close(a, b, name):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-6, err_msg=name)

    close(got.theta.e, state.theta.e, "theta_e")
    close(got.beta.e, state.beta.e, "beta_e")
    if variant == "hpf":
        close(got.theta_rate.e, state.theta_rate.e, "xi")
        close(got.beta_rate.e, state.beta_rate.e, "eta")
    if cfg.bias:
        close(got.theta_bias.e, state.theta_bias.e, "tbias")
        close(got.beta_bias.e, state.beta_bias.e, "bbias")


def test_sharded_hybrid_ragged_shards(rng):
    """Users concentrated in the first shards: later shards carry empty
    or tiny tails, exercising the all-padding TailCompact leaves."""
    from hgaprec_jax.data.ratings import RatingsStore
    n, m = 64, 40
    nnz = 300
    u = np.sort(rng.integers(0, 9, nnz)).astype(np.int64)   # shard 0 only
    i = rng.integers(0, m, nnz).astype(np.int64)
    y = rng.integers(1, 4, nnz).astype(np.float64)
    store = RatingsStore(n, m)
    store.add_training(u + 1, i + 1, y)
    store.finalize()
    cfg = _cfg(store)
    state = _single(store, cfg, steps=2)

    run = build_sharded_run(store, cfg, make_mesh(), seed=11,
                            pad_multiple=128)
    assert run.data.tail_compact is not None
    for _ in range(2):
        run.step()
    got = run.unsharded_state()
    np.testing.assert_allclose(np.asarray(got.theta.e),
                               np.asarray(state.theta.e),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.beta.e),
                               np.asarray(state.beta.e),
                               rtol=2e-4, atol=1e-6)


def test_sharded_hybrid_multi_step(rng):
    """The fused multi-step dispatch through the sharded hybrid path."""
    store, _, _ = make_synthetic(rng, n=70, m=45, density=0.3)
    cfg = _cfg(store)
    state = _single(store, cfg, steps=4)
    run = build_sharded_run(store, cfg, make_mesh(), seed=11,
                            pad_multiple=128)
    run.multi_step(4)
    got = run.unsharded_state()
    np.testing.assert_allclose(np.asarray(got.theta.e),
                               np.asarray(state.theta.e),
                               rtol=2e-4, atol=1e-6)
