"""Trainer-level e2e through the hybrid head/tail sweep.

VERDICT r2 #1: the engine's big-sparse default (hybrid layout for
catalogs too wide to densify) must be exercised through the Trainer —
reports, stopping, checkpoints — not just the raw sweep. The data-layout
knobs (ModelConfig.hybrid_head_items / dense_limit_bytes) let the same
decision logic run at CPU test scale.
"""

import numpy as np

from conftest import make_synthetic
from hgaprec_jax.config import ModelConfig, RunConfig
from hgaprec_jax.models.engine import Trainer
from hgaprec_jax.models.step import _resolve_mode


def _trainer(tmp_path, rng, mcfg_kw, n=60, m=45):
    store, validation, test = make_synthetic(rng, n=n, m=m, density=0.25)
    mcfg = ModelConfig(n=store.n, m=store.m, k=4, **mcfg_kw)
    rcfg = RunConfig(datdir=str(tmp_path), outdir=str(tmp_path / "out"),
                     rfreq=3, max_iterations=9, seed=1,
                     enforce_max_iterations=True)
    return Trainer(store, validation, test, mcfg, rcfg), store


def test_hybrid_trainer_end_to_end(tmp_path, rng):
    """The big-sparse engine configuration (head block + compact tail,
    catalog too wide to densify — tiny dense_limit_bytes stands in for
    the real 10 GiB bound; explicit sweep='hybrid' plays the
    m>65536 auto trigger at CPU scale) -> training runs end to end
    through the Trainer and matches the segment-sweep trajectory."""
    tr, store = _trainer(tmp_path, rng,
                         dict(variant="hpf", sweep="hybrid",
                              hybrid_head_items=8,
                              dense_limit_bytes=64))
    assert tr.data.dense_y is None            # too wide to densify
    assert tr.data.head_dense_y is not None   # head block built
    assert tr.data.head_dense_y.shape[1] == 8
    assert tr.data.tail_compact is not None   # MXU tail stream built
    assert _resolve_mode(tr.mcfg, tr.data) == "hybrid"

    state = tr.run()
    tr.close()
    assert np.isfinite(np.asarray(state.theta.e)).all()
    # full report/file contract went through the hybrid path
    rows = open(tmp_path / "out" / "validation.txt").read().splitlines()
    assert len(rows) >= 2
    assert open(tmp_path / "out" / "precision.txt").read().strip()

    # trajectory parity: the same config through the segment sweep
    rng2 = np.random.default_rng(42)
    tr2, _ = _trainer(tmp_path / "b", rng2,
                      dict(variant="hpf", sweep="segment"))
    state2 = tr2.run()
    tr2.close()
    np.testing.assert_allclose(np.asarray(state.theta.e),
                               np.asarray(state2.theta.e),
                               rtol=5e-3, atol=1e-5)


def test_auto_stays_dense_when_affordable(tmp_path, rng):
    """auto + densifiable catalog -> dense_y built, NO head block (the
    advisor's dead-weight finding), dense mode resolved."""
    tr, _ = _trainer(tmp_path, rng, dict(variant="bpf", sweep="auto"))
    assert tr.data.dense_y is not None
    assert tr.data.head_dense_y is None
    assert _resolve_mode(tr.mcfg, tr.data) == "dense"
    tr.close()
