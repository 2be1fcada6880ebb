"""Factor exploration (mlens.R analog) and marginal fit comparison
(marg.R analog)."""

import numpy as np

from hgaprec_jax.eval import analysis
from hgaprec_jax.eval.explore import (active_items_per_factor,
                                      format_factor_report, related_items,
                                      top_factors_of_user,
                                      top_items_by_factor)


def _beta():
    # 6 items x 3 factors; factor 2 is degenerate (one active item)
    return np.array([
        [9.0, 0.1, 0.0],
        [8.0, 0.2, 0.0],
        [0.1, 7.0, 0.0],
        [0.2, 6.0, 0.0],
        [0.3, 0.3, 5.0],
        [7.0, 0.1, 0.0],
    ])


def test_top_items_by_factor():
    top = top_items_by_factor(_beta(), 0, topn=3,
                              names={10: "A", 11: "B", 15: "F"},
                              seq2movie={0: 10, 1: 11, 5: 15})
    assert [t[0] for t in top] == [0, 1, 5]
    assert [t[2] for t in top] == ["A", "B", "F"]


def test_degenerate_factor_skipped():
    beta = _beta()
    active = active_items_per_factor(beta)
    assert active[2] == 1          # only item 4 above the mean threshold
    theta = np.array([[0.1, 0.2, 9.0]])   # user loves the degenerate factor
    facs = top_factors_of_user(theta, 0, topn=2, beta_e=beta)
    assert 2 not in facs           # mlens.R skips unused factors


def test_related_items_share_factors():
    rel = related_items(_beta(), 0, per_factor=3, n_factors=1)
    (fac, items), = rel.items()
    assert fac == 0
    assert [i[0] for i in items] == [0, 1, 5]


def test_format_factor_report():
    txt = format_factor_report(_beta(), [0, 1], topn=2)
    assert txt.splitlines()[0] == "FACTOR 0"
    assert "FACTOR 1" in txt


def test_marginal_fit_nb_wins_on_overdispersed():
    rng = np.random.default_rng(0)
    # NB(r=0.5, mu=20): heavy-tailed like user-activity marginals
    lam = rng.gamma(0.5, 40.0, 4000)
    counts = rng.poisson(lam)
    rep = analysis.marginal_fit_report(counts)
    assert rep["nb_wins"] == 1.0
    assert rep["loglik_nb"] > rep["loglik_gauss"]
    assert rep["aic_nb"] < rep["aic_gauss"]


def test_marginal_fit_gauss_wins_on_gaussian():
    rng = np.random.default_rng(1)
    counts = np.clip(rng.normal(1000, 5, 4000), 1, None).round()
    rep = analysis.marginal_fit_report(counts)
    assert rep["nb_wins"] == 0.0
