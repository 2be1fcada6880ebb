"""End-to-end: dataset files -> Trainer -> output-file contract."""

import os

import numpy as np
import pytest

from conftest import make_synthetic
from hgaprec_jax.config import ModelConfig, RunConfig
from hgaprec_jax.data.ratings import load_dataset
from hgaprec_jax.models.engine import Trainer


def write_dataset(tmpdir, rng, n=60, m=40, density=None):
    """Write train/validation/test tsv files from the generative model."""
    from hgaprec_jax.data.synthetic import write_pf_dataset
    write_pf_dataset(str(tmpdir), rng, n, m, k=3, scale=6.0,
                     test_frac=0.15, valid_frac=0.1)
    return n, m


def test_load_dataset_roundtrip(tmp_path, rng):
    n, m = write_dataset(str(tmp_path), rng)
    store, validation, test = load_dataset(str(tmp_path), n, m,
                                           binary=False, rating_threshold=1)
    assert store.n > 0 and store.m > 0
    assert store.nratings > 0
    assert len(validation) > 0 and len(test) > 0
    # id remap: external = seq offset consistency
    some_u = store.coo_u[0]
    assert store.user2seq[store.seq2user[int(some_u)]] == int(some_u)
    # lookups
    assert store.r(int(store.coo_u[0]), int(store.coo_i[0])) == \
        int(store.coo_y[0])


def test_binary_thresholding(tmp_path, rng):
    n, m = write_dataset(str(tmp_path), rng)
    store, validation, test = load_dataset(str(tmp_path), n, m,
                                           binary=True, rating_threshold=4)
    # all stored ratings are 1; entries below threshold dropped
    assert (store.coo_y == 1).all()
    assert all(v == 1 for v in test.values())


@pytest.mark.parametrize("variant", ["bpf", "hpf"])
def test_trainer_end_to_end(tmp_path, rng, variant):
    n, m = write_dataset(str(tmp_path), rng)
    store, validation, test = load_dataset(str(tmp_path), n, m,
                                           binary=False, rating_threshold=1)
    mcfg = ModelConfig(n=store.n, m=store.m, k=3, variant=variant)
    outdir = str(tmp_path / "out")
    rcfg = RunConfig(datdir=str(tmp_path), outdir=outdir, rfreq=5, seed=1,
                     max_iterations=12, logl=True,
                     num_precision_users=10)
    tr = Trainer(store, validation, test, mcfg, rcfg)
    tr.run(max_iters=12)
    tr.close()

    for fname in ("param.txt", "validation.txt", "test.txt",
                  "precision.txt", "logl.txt", "byusers.tsv",
                  "byitems.tsv", "max.txt", "model.npz"):
        assert os.path.exists(os.path.join(outdir, fname)), fname
    # validation.txt rows: iter \t secs \t avg \t count
    rows = open(os.path.join(outdir, "validation.txt")).read().splitlines()
    assert len(rows) >= 2
    parts = rows[0].split("\t")
    assert len(parts) == 4 and int(parts[0]) == 0
    assert float(parts[2]) < 0  # log-likelihood
    # all reported likelihoods finite negative (quality parity is asserted
    # at realistic scale by the bench / golden step tests)
    vals = [float(r.split("\t")[2]) for r in rows]
    assert all(np.isfinite(v) and v < 0 for v in vals)
    # precision rows: users p10 p100
    prow = open(os.path.join(outdir, "precision.txt")).read().splitlines()[0]
    assert len(prow.split("\t")) == 3
    # checkpoint TSVs use reference family names
    expected = ("htheta.tsv" if variant == "hpf" else "theta.tsv")
    assert os.path.exists(os.path.join(outdir, expected))
    # ELBO written
    assert len(open(os.path.join(outdir, "logl.txt")).read().split()) >= 2


def test_stopping_rule_fires(tmp_path, rng):
    """On tiny data validation declines; after iter 30 the 3-consecutive-
    decreases rule (hgaprec.cc:1484-1491) must stop training and write the
    final ranking via do_on_stop()."""
    n, m = write_dataset(str(tmp_path), rng)
    store, validation, test = load_dataset(str(tmp_path), n, m,
                                           binary=False, rating_threshold=1)
    mcfg = ModelConfig(n=store.n, m=store.m, k=3)
    outdir = str(tmp_path / "out")
    rcfg = RunConfig(datdir=str(tmp_path), outdir=outdir, rfreq=1, seed=1,
                     num_precision_users=5)
    tr = Trainer(store, validation, test, mcfg, rcfg)
    tr.run(max_iters=500)
    assert tr._stop_requested
    assert tr.iteration < 500
    why = open(os.path.join(outdir, "max.txt")).read().split("\t")[3]
    assert int(why) in (0, 1)
    # do_on_stop wrote the model and ranking for test_users.tsv
    assert os.path.exists(os.path.join(outdir, "ranking.tsv"))
    tr.close()


def test_max_iterations_exit_runs_do_on_stop(tmp_path, rng):
    """Hitting the iteration cap must still save the model and write the
    ranking, matching the reference's max-iterations exit path
    (hgaprec.cc:1336-1339 -> do_on_stop)."""
    n, m = write_dataset(str(tmp_path), rng)
    store, validation, test = load_dataset(str(tmp_path), n, m,
                                           binary=False, rating_threshold=1)
    mcfg = ModelConfig(n=store.n, m=store.m, k=3, variant="hpf")
    outdir = str(tmp_path / "out")
    rcfg = RunConfig(datdir=str(tmp_path), outdir=outdir, rfreq=100, seed=1,
                     num_precision_users=5)
    tr = Trainer(store, validation, test, mcfg, rcfg)
    tr.run(max_iters=3)
    assert not tr._stop_requested          # cap exit, not convergence
    assert os.path.exists(os.path.join(outdir, "ranking.tsv"))
    assert os.path.exists(os.path.join(outdir, "htheta.tsv"))
    tr.close()


def test_checkpoint_roundtrip(tmp_path, rng):
    n, m = write_dataset(str(tmp_path), rng)
    store, validation, test = load_dataset(str(tmp_path), n, m,
                                           binary=False, rating_threshold=1)
    mcfg = ModelConfig(n=store.n, m=store.m, k=3, variant="hpf")
    outdir = str(tmp_path / "out")
    rcfg = RunConfig(datdir=str(tmp_path), outdir=outdir, rfreq=100, seed=1)
    tr = Trainer(store, validation, test, mcfg, rcfg)
    tr.run(max_iters=3)
    tr.save_model()
    e_before = np.asarray(tr.state.theta.e)
    it_before = tr.iteration
    tr.close()

    tr2 = Trainer(store, validation, test, mcfg, rcfg)
    tr2.load_model()
    np.testing.assert_allclose(np.asarray(tr2.state.theta.e), e_before,
                               rtol=1e-6)
    assert tr2.iteration == it_before
    # TSV-only load path (reference parity)
    os.remove(os.path.join(outdir, "model.npz"))
    tr3 = Trainer(store, validation, test, mcfg, rcfg)
    tr3.load_model()
    np.testing.assert_allclose(np.asarray(tr3.state.theta.e), e_before,
                               rtol=1e-4, atol=1e-6)
    tr2.close()
    tr3.close()


def test_gen_ranking_writes_files(tmp_path, rng):
    n, m = write_dataset(str(tmp_path), rng)
    store, validation, test = load_dataset(str(tmp_path), n, m,
                                           binary=False, rating_threshold=1)
    mcfg = ModelConfig(n=store.n, m=store.m, k=3)
    outdir = str(tmp_path / "out")
    rcfg = RunConfig(datdir=str(tmp_path), outdir=outdir, rfreq=100, seed=1)
    tr = Trainer(store, validation, test, mcfg, rcfg)
    tr.run(max_iters=2)
    tr.gen_ranking_for_users(load=False)
    assert os.path.exists(os.path.join(outdir, "ranking.tsv"))
    assert os.path.exists(os.path.join(outdir, "itemrank.tsv"))
    assert os.path.exists(os.path.join(outdir, "meanrank.txt"))
    rows = open(os.path.join(outdir, "ranking.tsv")).read().splitlines()
    assert rows and len(rows[0].split("\t")) == 4
    tr.gen_msr_csv()
    pred = open(os.path.join(outdir, "pred.csv")).read().splitlines()
    assert pred[0].startswith("User\tHeldOutItem")
    tr.compute_rmse()
    assert os.path.exists(os.path.join(outdir, "rmse.txt"))
    tr.close()
