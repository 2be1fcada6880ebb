#!/usr/bin/env python
"""Render the paper's figures from a run's output directory — the
capability of plots/src/plots.R and marg.R, natively.

Reads the reference-format output files (ranking.tsv, validation.txt,
precision.txt, byusers.tsv, byitems.tsv) written by the Trainer and
produces PNGs:

  precision_recall.png   precision@k / recall@k curves (analysis.R:95-133)
  likelihood.png         validation log-likelihood vs iteration and time
  marginals.png          user-activity / item-popularity histograms with
                         NB vs Gaussian fits (marg.R)

Usage: python scripts/plot_curves.py OUTDIR [--test-tsv data/test.tsv]
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import matplotlib  # noqa: E402
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from hgaprec_jax.eval import analysis  # noqa: E402


def plot_precision_recall(outdir, test_tsv=None):
    rk = os.path.join(outdir, "ranking.tsv")
    if not os.path.exists(rk):
        return False
    ranking = analysis.load_ranking_tsv(rk)
    users = np.unique(ranking[:, 0]).astype(int)
    if test_tsv and os.path.exists(test_tsv):
        # true num.test.items per user (external ids), like analysis.R's
        # test-set input
        d = np.loadtxt(test_tsv, ndmin=2)
        tipu = {}
        for u in d[:, 0].astype(int):
            tipu[u] = tipu.get(u, 0) + 1
        tipu = {int(u): max(tipu.get(int(u), 0), 1) for u in users}
    else:
        # fallback: hits visible in the top-100 window (lower bound)
        tipu = {int(u): max(int((ranking[ranking[:, 0] == u][:, 3]
                                 > 0).sum()), 1) for u in users}
    ks = tuple(range(10, 101, 10))
    prec, rec = analysis.precision_recall_curves(ranking, tipu, ks)
    fig, ax = plt.subplots(1, 2, figsize=(9, 3.5))
    ax[0].plot(ks, prec, marker="o", ms=3)
    ax[0].set_xlabel("top-k recommendations")
    ax[0].set_ylabel("mean precision@k")
    ax[1].plot(ks, rec, marker="o", ms=3, color="tab:orange")
    ax[1].set_xlabel("top-k recommendations")
    ax[1].set_ylabel("mean recall@k")
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "precision_recall.png"), dpi=120)
    plt.close(fig)
    return True


def plot_likelihood(outdir):
    va = os.path.join(outdir, "validation.txt")
    if not os.path.exists(va) or os.path.getsize(va) == 0:
        return False
    d = np.loadtxt(va, ndmin=2)
    fig, ax = plt.subplots(1, 2, figsize=(9, 3.5))
    ax[0].plot(d[:, 0], d[:, 2], marker="o", ms=3)
    ax[0].set_xlabel("iteration")
    ax[0].set_ylabel("validation log-likelihood")
    ax[1].plot(d[:, 1], d[:, 2], marker="o", ms=3, color="tab:green")
    ax[1].set_xlabel("seconds")
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "likelihood.png"), dpi=120)
    plt.close(fig)
    return True


def plot_marginals(outdir):
    done = False
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    for ax, fname, title in ((axes[0], "byusers.tsv", "user activity"),
                             (axes[1], "byitems.tsv", "item popularity")):
        p = os.path.join(outdir, fname)
        if not os.path.exists(p) or os.path.getsize(p) == 0:
            continue
        d = np.loadtxt(p, ndmin=2)
        counts = d[:, 1]
        rep = analysis.marginal_fit_report(counts)
        ax.hist(counts, bins=min(60, max(int(counts.max()), 5)),
                density=True, alpha=0.4, label="data")
        xs = np.linspace(counts.min(), counts.max(), 200)
        sd = rep["gauss_sd"]
        ax.plot(xs, np.exp(-0.5 * ((xs - rep["gauss_mean"]) / sd) ** 2)
                / (sd * np.sqrt(2 * np.pi)), label="gauss")
        winner = "NB" if rep["nb_wins"] else "gauss"
        ax.set_title(f"{title} (AIC winner: {winner})")
        ax.set_xscale("log")
        ax.legend()
        done = True
    if done:
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, "marginals.png"), dpi=120)
    plt.close(fig)
    return done


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--test-tsv", default=None,
                    help="test.tsv for true per-user test-set sizes")
    args = ap.parse_args()
    made = []
    if plot_precision_recall(args.outdir, args.test_tsv):
        made.append("precision_recall.png")
    if plot_likelihood(args.outdir):
        made.append("likelihood.png")
    if plot_marginals(args.outdir):
        made.append("marginals.png")
    print(f"wrote {made} in {args.outdir}")


if __name__ == "__main__":
    main()
