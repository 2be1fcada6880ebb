"""Baseline-bridge file format round trips."""

import os

import numpy as np

from conftest import make_synthetic
from hgaprec_jax.data import formats
from hgaprec_jax.data.ratings import RatingsStore


def _store(rng):
    store, validation, test = make_synthetic(rng, n=20, m=15, density=0.4)
    return store, validation


def test_lda_training_matrix(tmp_path, rng):
    store, _ = _store(rng)
    n = formats.write_lda_training_matrix(store, str(tmp_path / "l.tsv"))
    lines = open(tmp_path / "l.tsv").read().splitlines()
    assert len(lines) == n
    first = lines[0].split()
    deg = int(first[0])
    assert len(first) == deg + 1
    item, y = first[1].split(":")
    assert store.r(0, int(item)) == int(y)


def test_chi_matrixmarket_roundtrip(tmp_path, rng):
    store, validation = _store(rng)
    formats.write_chi_training_matrix(store, validation, str(tmp_path))
    head = open(tmp_path / "chitrain.tsv").read().splitlines()
    assert head[0] == "%%MatrixMarket matrix coordinate real general"
    nu, ni, nr = (int(x) for x in head[1].split())
    assert nr == store.nratings
    # 1-based coordinates
    u1, m1, y1 = (int(x) for x in head[2].split())
    assert store.r(u1 - 1, m1 - 1) == y1


def test_mm_load_rowmajor(tmp_path):
    path = tmp_path / "f.mm"
    path.write_text("%%MatrixMarket matrix array real general\n%\n2 3\n"
                    "1.5 2.5 3.5\n4.5 5.5 6.5\n")
    out = formats.mm_load_rowmajor(str(path), 2, 3)
    np.testing.assert_allclose(out, [[1.5, 2.5, 3.5], [4.5, 5.5, 6.5]])


def test_lda_factor_import(tmp_path):
    n, m, k = 3, 4, 2
    (tmp_path / "gamma.tsv").write_text("1 3\n2 2\n4 4\n")
    # beta: [k, m] log probs
    (tmp_path / "beta.tsv").write_text("0 -1 -2 -3\n-3 -2 -1 0\n")
    theta, beta = formats.load_lda_factors(
        n, m, k, str(tmp_path / "gamma.tsv"), str(tmp_path / "beta.tsv"))
    np.testing.assert_allclose(theta.sum(1), 1.0)
    assert beta.shape == (m, k)
    np.testing.assert_allclose(beta[0], [np.exp(0), np.exp(-3)])


def test_ctr_import(tmp_path):
    (tmp_path / "final-U.dat").write_text("1 2\n3 4\n")
    (tmp_path / "final-V.dat").write_text("5 6\n7 8\n9 10\n")
    (tmp_path / "user_map.dat").write_text("100,0\n101,1\n")
    (tmp_path / "item_map.dat").write_text("200,0\n201,1\n202,2\n")
    theta, beta, umap, imap = formats.load_ctr_factors(
        2, 3, 2, str(tmp_path))
    assert theta.shape == (2, 2) and beta.shape == (3, 2)
    assert umap[101] == 1 and imap[202] == 2


def test_nmf_training_matrix(tmp_path, rng):
    store, _ = _store(rng)
    nrows = formats.write_nmf_training_matrix(store,
                                              str(tmp_path / "t.tsv"))
    lines = open(tmp_path / "t.tsv").read().splitlines()
    assert int(lines[0]) == nrows
    assert int(lines[1]) == store.m
    row0 = [int(v) for v in lines[2].split()]
    assert len(row0) == store.m


def test_nmf_load_factors(tmp_path):
    """-nmfload importer: 2 header lines, theta [n,k] direct, beta
    auto-oriented (matrix.hh:1370-1423 intent)."""
    (tmp_path / "theta.tsv").write_text(
        "h1\nh2\n1 2\n3 4\n5 6\n")                       # n=3, k=2
    (tmp_path / "beta.tsv").write_text(
        "h1\nh2\n10 20 30 40\n50 60 70 80\n")            # [k=2, m=4]
    theta, beta = formats.nmf_load_factors(
        3, 4, 2, str(tmp_path / "theta.tsv"), str(tmp_path / "beta.tsv"))
    np.testing.assert_allclose(theta, [[1, 2], [3, 4], [5, 6]])
    np.testing.assert_allclose(beta, [[10, 50], [20, 60], [30, 70],
                                      [40, 80]])
    # [m, k] orientation also accepted
    (tmp_path / "beta2.tsv").write_text(
        "h1\nh2\n10 50\n20 60\n30 70\n40 80\n")
    _, beta2 = formats.nmf_load_factors(
        3, 4, 2, str(tmp_path / "theta.tsv"), str(tmp_path / "beta2.tsv"))
    np.testing.assert_allclose(beta2, beta)


def test_apply_ctr_maps():
    """CTR rows placed through the id maps (hgaprec.cc:1893-1926)."""
    theta = np.asarray([[1.0, 1], [2, 2]])
    beta = np.asarray([[3.0, 3], [4, 4], [5, 5]])
    seq2user = {0: 100, 1: 101}
    seq2movie = {0: 200, 1: 201, 2: 202}
    umap = {100: 1, 101: 0}          # ext -> ctr row
    imap = {200: 2, 201: 0, 202: 1}
    t, b = formats.apply_ctr_maps(theta, beta, umap, imap,
                                  seq2user, seq2movie, 2, 3)
    np.testing.assert_allclose(t, [[2, 2], [1, 1]])
    np.testing.assert_allclose(b, [[5, 5], [3, 3], [4, 4]])


def test_chi_command_tools(tmp_path):
    """Per-tool argument parity with run_chi_* (hgaprec.cc:533-643)."""
    for tool, frag in (("als", "--lambda=0.01"),
                       ("wals", "--implicitratingtype=1"),
                       ("climf", "--sgd_step_dec=0.9999"),
                       ("biassgd", "--biassgd_gamma=1e-3"),
                       ("pmf", "--pmf_burn_in=5"),
                       ("nmf", "--max_iter=500")):
        cmd = formats.chi_command(tool, str(tmp_path), 7,
                                  graphchi_root="/gc")
        assert frag in cmd, (tool, cmd)
        assert "--D=7" in cmd
        if tool in ("nmf",):
            assert "chifull.tsv" in cmd and "--validation" not in cmd
        elif tool in ("pmf",):
            assert "--validation" not in cmd
        else:
            assert "chivalidation.tsv" in cmd
