#!/usr/bin/env python
"""Render the reference-vs-framework parity curves (the JSON that
`scripts/parity_check.py report` writes, .bench_cache/parity/parity.json)
as small multiples: validation log-likelihood and training ELBO per
model config. Output: parity_curves.png beside the input.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

# categorical slots 1-2 of the validated default palette (dataviz
# reference instance): color follows the entity across every panel
C_REF = "#2a78d6"    # reference binary
C_OURS = "#eb6834"   # this framework
INK = "#333333"
MUTED = "#777777"

CONFIG_TITLES = {
    "bpf": "BPF", "bpfbin": "BPF binary", "bpfbias": "BPF bias",
    "hpf": "HPF",
}


def style(ax):
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color("#cccccc")
    ax.grid(True, axis="y", color="#e8e8e8", linewidth=0.6)
    ax.tick_params(colors=MUTED, labelsize=8)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(ROOT, ".bench_cache", "parity", "parity.json")
    d = json.load(open(path))
    cfgs = [c for c in ("bpf", "bpfbin", "bpfbias", "hpf") if c in d]
    fig, axes = plt.subplots(2, len(cfgs), figsize=(3.1 * len(cfgs), 5.4),
                             dpi=150)
    for j, cfg in enumerate(cfgs):
        r, o = d[cfg]["ref"], d[cfg]["ours"]
        ax = axes[0, j]
        ax.plot([p[0] for p in r["val_curve"]],
                [p[2] for p in r["val_curve"]],
                color=C_REF, linewidth=2, label="reference binary")
        ax.plot([p[0] for p in o["val_curve"]],
                [p[2] for p in o["val_curve"]],
                color=C_OURS, linewidth=2, label="this framework")
        ax.set_title(CONFIG_TITLES[cfg], fontsize=10, color=INK)
        if j == 0:
            ax.set_ylabel("validation log-lik", fontsize=9, color=INK)
        style(ax)

        ax = axes[1, j]
        ax.plot(range(len(r["elbo_curve"])),
                [v / 1e6 for v in r["elbo_curve"]],
                color=C_REF, linewidth=2)
        ax.plot(range(len(o["elbo_curve"])),
                [v / 1e6 for v in o["elbo_curve"]],
                color=C_OURS, linewidth=2)
        ax.set_xlabel("report", fontsize=9, color=INK)
        if j == 0:
            ax.set_ylabel("training ELBO (1e6)", fontsize=9, color=INK)
        style(ax)
    axes[0, 0].legend(frameon=False, fontsize=8, loc="lower left")
    fig.suptitle("Reference binary vs JAX implementation — shared ML-1M-scale "
                 "dataset, K=100", fontsize=11, color=INK)
    fig.tight_layout(rect=(0, 0, 1, 0.96))
    out = os.path.join(os.path.dirname(os.path.abspath(path)),
                       "parity_curves.png")
    fig.savefig(out)
    print(out)


if __name__ == "__main__":
    main()
