"""Streamed device rank counter == host argsort ranks (scale-out evals).

The big-catalog paths of compute_itemrank and gen_msr_csv replace the
[S, M] host score matrix with eval/topk.py::item_ranks; these tests pin
them to the small-scale host implementations on the same data.
"""

import numpy as np

from conftest import make_synthetic
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.data.device import build_device_data
from hgaprec_jax.data.ratings import leave_one_out_map, \
    validation_users_of_movie
from hgaprec_jax.eval import ranking as rank_mod
from hgaprec_jax.eval.ranking import EvalIndex, masked_user_scores
from hgaprec_jax.eval.score import scorer_from_state
from hgaprec_jax.eval.topk import item_ranks
from hgaprec_jax.models.state import init_state


def _setup(rng, bias=False):
    store, validation, test = make_synthetic(rng, n=41, m=33, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant="bpf", bias=bias)
    state = init_state(cfg, seed=5)
    sc = scorer_from_state(state, cfg)
    index = EvalIndex(validation, test, store)
    return store, validation, test, sc, index


def test_item_ranks_matches_argsort(rng):
    store, validation, test, sc, index = _setup(rng)
    users, items = [], []
    for (u, m) in test.keys():
        users.append(u)
        items.append(m)
    users = np.asarray(users[:50])
    items = np.asarray(items[:50])

    ranks, tgts = item_ranks(sc, store, index, users, items,
                             item_chunk=8, pair_chunk=16)

    uniq = np.unique(users)
    scores = masked_user_scores(sc, store, index, uniq)
    row = {int(n): r for r, n in enumerate(uniq)}
    for p, (n, mm) in enumerate(zip(users, items)):
        s = scores[row[int(n)]]
        order = np.argsort(-s, kind="stable")
        rank_of = np.empty_like(order)
        rank_of[order] = np.arange(order.size)
        assert int(ranks[p]) == int(rank_of[mm]), (n, mm)
        np.testing.assert_allclose(tgts[p], s[mm], rtol=1e-6)


def test_itemrank_device_path_matches_host(rng, tmp_path, monkeypatch):
    store, validation, test, sc, index = _setup(rng)
    users = np.asarray(sorted({u for (u, m) in test.keys()}), np.int32)

    host_dir = tmp_path / "host"
    dev_dir = tmp_path / "dev"
    host_dir.mkdir()
    dev_dir.mkdir()
    r_host = rank_mod.compute_itemrank(sc, store, index, users,
                                       str(host_dir))
    monkeypatch.setattr(rank_mod, "DEVICE_TOPK_THRESHOLD", 1)
    r_dev = rank_mod.compute_itemrank(sc, store, index, users,
                                      str(dev_dir))
    assert r_host["users"] == r_dev["users"]
    np.testing.assert_allclose(r_host["meanrank"], r_dev["meanrank"],
                               rtol=1e-6)
    np.testing.assert_allclose(r_host["mrr"], r_dev["mrr"], rtol=1e-6)
    a = (host_dir / "itemrank.tsv").read_text().splitlines()
    b = (dev_dir / "itemrank.tsv").read_text().splitlines()
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        pa, pb = la.split("\t"), lb.split("\t")
        assert pa[0] == pb[0] and pa[1] == pb[1] and pa[3] == pb[3]


def test_msr_device_path_matches_host(rng, tmp_path, monkeypatch):
    store, validation, test, sc, index = _setup(rng)
    loo = leave_one_out_map(test)
    vum = validation_users_of_movie(validation)

    host_dir = tmp_path / "host"
    dev_dir = tmp_path / "dev"
    host_dir.mkdir()
    dev_dir.mkdir()
    rank_mod.gen_msr_csv(sc, store, index, loo, vum, str(host_dir))
    monkeypatch.setattr(rank_mod, "MSR_HOST_CELL_BUDGET", 1)
    rank_mod.gen_msr_csv(sc, store, index, loo, vum, str(dev_dir))
    a = (host_dir / "pred.csv").read_text()
    b = (dev_dir / "pred.csv").read_text()
    assert a == b
