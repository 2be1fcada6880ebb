"""Sharded == single-device: CAVI over an 8-device CPU mesh."""

import numpy as np
import pytest
import jax

from conftest import make_synthetic
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.data.device import build_device_data
from hgaprec_jax.models.state import init_state
from hgaprec_jax.models.step import make_step
from hgaprec_jax.parallel.sharded import build_sharded_run, make_mesh


@pytest.mark.parametrize("variant,kw,dense", [
    ("bpf", {}, True),
    ("bpf", {"bias": True}, False),
    ("hpf", {}, True),
    ("hpf", {}, False),
    ("mle_user", {}, True),
    ("canny", {}, False),
])
def test_sharded_matches_single(rng, variant, kw, dense):
    assert len(jax.devices()) == 8
    store, validation, test = make_synthetic(rng, n=53, m=31, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant=variant,
                      sweep="dense" if dense else "segment", **kw)

    # single device
    data = build_device_data(store, pad_multiple=128)
    state = init_state(cfg, seed=11)
    step = make_step(cfg)
    for _ in range(3):
        state = step(state, data)

    # sharded over 8 devices
    run = build_sharded_run(store, cfg, make_mesh(), seed=11,
                            pad_multiple=128, dense=dense)
    for _ in range(3):
        run.step()
    got = run.unsharded_state()

    def close(a, b, name):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=1e-6, err_msg=name)

    if variant != "mle_user":
        close(got.theta.e, state.theta.e, "theta_e")
        # elog is not gathered (no host path reads it); shape/rate are
        # the checkpoint payload and pin the same information
        close(got.theta.shape, state.theta.shape, "theta_shape")
        close(got.theta.rate, state.theta.rate, "theta_rate")
    if variant not in ("mle_item", "canny"):
        close(got.beta.e, state.beta.e, "beta_e")
    if variant == "hpf":
        close(got.theta_rate.e, state.theta_rate.e, "xi")
        close(got.beta_rate.e, state.beta_rate.e, "eta")
    if cfg.bias:
        close(got.theta_bias.e, state.theta_bias.e, "tbias")
        close(got.beta_bias.e, state.beta_bias.e, "bbias")
    if variant == "mle_user":
        close(got.theta_mle, state.theta_mle, "theta_mle")
    if variant == "canny":
        close(got.beta_mle, state.beta_mle, "beta_mle")


def test_sharded_topk_matches_streamed(rng):
    """Item-sharded top-k (all_gather merge) == single-device streamed."""
    from hgaprec_jax.eval.topk import masked_topk
    from hgaprec_jax.models.step import make_step
    from hgaprec_jax.eval.ranking import EvalIndex
    from hgaprec_jax.eval.score import scorer_from_state
    from hgaprec_jax.parallel.sharded import sharded_masked_topk

    store, validation, test = make_synthetic(rng, n=37, m=61, density=0.25)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant="bpf")
    data = build_device_data(store, pad_multiple=128)
    state = init_state(cfg, seed=3)
    step = make_step(cfg)
    for _ in range(2):
        state = step(state, data)
    sc = scorer_from_state(state, cfg)
    index = EvalIndex(validation, test)
    users = np.arange(0, store.n, 3)

    masks = []
    for n in users:
        masks.append(np.union1d(store.items_of_user(int(n)),
                                index.val_items(int(n))).astype(np.int64))
    d = max(max((mk.size for mk in masks), default=1), 1)
    mask_cols = np.full((len(users), d), -(10 ** 9), np.int32)
    for r, mk in enumerate(masks):
        mask_cols[r, :mk.size] = mk

    v_ref, i_ref = masked_topk(sc, store, index, users, k=7)
    v_got, i_got = sharded_masked_topk(sc, make_mesh(), users, mask_cols,
                                       k=7)
    np.testing.assert_allclose(v_got, v_ref, rtol=1e-5, atol=1e-6)
    # ids may legitimately differ only on exact score ties
    ties = np.isclose(v_ref, np.roll(v_ref, 1, axis=1))
    same = (i_got == i_ref) | ties | np.roll(ties, -1, axis=1)
    assert same.all()


def test_sharded_topk_bias_and_small_k(rng):
    """Bias path + k larger than one shard's local item count."""
    from hgaprec_jax.eval.ranking import EvalIndex
    from hgaprec_jax.eval.score import scorer_from_state
    from hgaprec_jax.eval.topk import masked_topk
    from hgaprec_jax.parallel.sharded import sharded_masked_topk

    store, validation, test = make_synthetic(rng, n=19, m=17, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=3, variant="bpf", bias=True)
    data = build_device_data(store, pad_multiple=128)
    state = init_state(cfg, seed=9)
    step = make_step(cfg)
    state = step(state, data)
    sc = scorer_from_state(state, cfg)
    index = EvalIndex(validation, test)
    users = np.arange(store.n, dtype=np.int64)
    masks = [np.union1d(store.items_of_user(int(n)),
                        index.val_items(int(n))).astype(np.int64)
             for n in users]
    d = max(max((mk.size for mk in masks), default=1), 1)
    mask_cols = np.full((len(users), d), -(10 ** 9), np.int32)
    for r, mk in enumerate(masks):
        mask_cols[r, :mk.size] = mk

    # k=5 > m_local=3 (17 items over 8 devices)
    v_ref, _ = masked_topk(sc, store, index, users, k=5)
    v_got, _ = sharded_masked_topk(sc, make_mesh(), users, mask_cols, k=5)
    np.testing.assert_allclose(v_got, v_ref, rtol=1e-5, atol=1e-6)


def test_uneven_rows_masked(rng):
    """n not divisible by ndev: padded rows must not perturb results."""
    store, _, _ = make_synthetic(rng, n=41, m=23, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=3, variant="hpf")
    data = build_device_data(store, pad_multiple=128)
    state = init_state(cfg, seed=5)
    step = make_step(cfg)
    for _ in range(2):
        state = step(state, data)
    run = build_sharded_run(store, cfg, make_mesh(), seed=5,
                            pad_multiple=128)
    for _ in range(2):
        run.step()
    got = run.unsharded_state()
    np.testing.assert_allclose(np.asarray(got.beta.e),
                               np.asarray(state.beta.e), rtol=2e-4,
                               atol=1e-6)


def test_report_gather_leaf_accounting(rng, monkeypatch):
    """VERDICT r4 #6: the per-report device->host transfer is bounded.

    'eval' gathers only the e expectations (1 leaf per Gam, 4x less
    than the old shape/rate/e/elog gather); 'full' gathers shape+rate
    (2 leaves) and derives e host-side with the exact clamped divide.
    Counted through a host_global spy; also pins the npz round trip
    with the derived (elog-less) state.
    """
    import hgaprec_jax.parallel.sharded as sh
    from hgaprec_jax.io import checkpoint as ckpt

    store, _, _ = make_synthetic(rng, n=53, m=31, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant="hpf", bias=True,
                      sweep="segment")
    run = build_sharded_run(store, cfg, make_mesh(), seed=1,
                            pad_multiple=128)
    run.step()

    counts = {"bytes": 0, "calls": 0}
    real = sh.host_global

    def spy(x):
        h = real(x)
        counts["bytes"] += h.nbytes
        counts["calls"] += 1
        return h

    monkeypatch.setattr(sh, "host_global", spy)
    st_eval = run.unsharded_state("eval")
    eval_bytes, eval_calls = counts["bytes"], counts["calls"]
    counts["bytes"] = counts["calls"] = 0
    st_full = run.unsharded_state("full")
    full_bytes, full_calls = counts["bytes"], counts["calls"]

    # eval: e only — 6 Gams (theta/beta, rates, biases), no shape/rate
    assert eval_calls == 6
    assert st_eval.theta.shape is None and st_eval.theta.elog is None
    # full: shape+rate per Gam (+ 4 tiny hier prior rows), elog dropped
    assert full_calls == 16
    assert st_full.theta.elog is None
    assert eval_bytes < full_bytes
    # old behavior was 4 leaves/Gam: e + elog + shape + rate; eval now
    # moves strictly the e leaves = 1/4 of that by construction
    old_bytes = eval_bytes * 4
    assert full_bytes < old_bytes

    # host-derived e == device e (exact clamped divide)
    np.testing.assert_allclose(np.asarray(st_full.theta.e),
                               np.asarray(st_eval.theta.e),
                               rtol=1e-6, atol=0)

    # checkpoint round trip from the elog-less state
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "model.npz")
        ckpt.save_npz(path, st_full, 7)
        st2, it2 = ckpt.load_npz(path, cfg)
    assert it2 == 7
    np.testing.assert_allclose(np.asarray(st2.theta.e),
                               np.asarray(st_full.theta.e), rtol=1e-6)
    assert st2.theta.elog is not None      # recomputed from shape/rate
