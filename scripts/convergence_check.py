#!/usr/bin/env python
"""End-to-end convergence run: HPF K=100 on MovieLens-1M-scale synthetic.

Unlike bench.py (raw CAVI step throughput), this drives the full Trainer
contract — fused rfreq-iteration dispatches, validation/test likelihood,
save_model, precision over 1000 sampled users, the reference stopping
rule (hgaprec.cc:1476-1491) — and reports wall-clock to convergence.
The single-threaded reference needs ~4.7 s per iteration on this host
for the sweep alone (native/ref_cavi_bench.cc), i.e. hours to the same
stopping point.

Writes .bench_cache/convergence.json. Usage:
  python scripts/convergence_check.py [variant] [k] [max_iters]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402

from hgaprec_jax.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

N, M = 6040, 3681
SEED = 20260817


def build(variant, k):
    from hgaprec_jax.data.ratings import RatingsStore
    from hgaprec_jax.data.synthetic import generate_pf_counts

    rng = np.random.default_rng(SEED)
    cache = os.path.join(ROOT, ".bench_cache", f"ml1m_{N}x{M}_{SEED}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        u, i, y = z["u"], z["i"], z["y"]
    else:
        u, i, y = generate_pf_counts(rng, N, M, k=8, a=0.3, ap=1.8, b=0.3,
                                     scale=0.7)
    # heldout split: 20% test / 1% validation by nonzero (env.hh:239-240)
    r = np.random.default_rng(SEED + 1).random(u.size)
    tr = r >= 0.21
    va = r < 0.01
    te = (r >= 0.01) & (r < 0.21)

    store = RatingsStore(N, M)
    store.user2seq = {int(x): int(x) for x in range(N)}
    store.seq2user = dict(store.user2seq)
    store.movie2seq = {int(x): int(x) for x in range(M)}
    store.seq2movie = dict(store.movie2seq)
    store._u = list(u[tr])
    store._i = list(i[tr])
    store._y = list(np.minimum(y[tr], 255))
    store.finalize()
    validation = {(int(a), int(b)): int(c)
                  for a, b, c in zip(u[va], i[va], y[va])}
    test = {(int(a), int(b)): int(c)
            for a, b, c in zip(u[te], i[te], y[te])}
    return store, validation, test


def main():
    variant = sys.argv[1] if len(sys.argv) > 1 else "hpf"
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    max_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 1000

    from hgaprec_jax.config import ModelConfig, RunConfig
    from hgaprec_jax.models.engine import Trainer

    store, validation, test = build(variant, k)
    print(f"train nnz={store.coo_y.size} validation={len(validation)} "
          f"test={len(test)}", flush=True)

    outdir = os.path.join(ROOT, ".bench_cache",
                          f"conv_{variant}_k{k}")
    mcfg = ModelConfig(n=N, m=M, k=k, variant=variant, sweep="dense",
                       matmul_precision="default")
    rcfg = RunConfig(datdir=os.path.join(ROOT, ".bench_cache"),
                     outdir=outdir, rfreq=10, seed=1,
                     max_iterations=max_iters,
                     enforce_max_iterations=True)
    from hgaprec_jax.models.state import init_state

    tr = Trainer(store, validation, test, mcfg, rcfg)
    # warmup pass: compile the fused chunk + step + every eval kernel on
    # these shapes, then reset the trajectory and the output files
    t0 = time.time()
    tr.run(max_iters=11)
    compile_s = time.time() - t0
    tr.close()
    tr._open_outputs()
    tr.state = init_state(mcfg, seed=rcfg.seed)
    tr.iteration = 0
    tr._prev_h, tr._nh = 0.0, 0
    tr._stop_requested = tr._on_stop_done = False
    tr.start_time = time.time()

    t0 = time.time()
    tr.run()
    wall = time.time() - t0
    iters = tr.iteration

    val_curve = []
    with open(os.path.join(tr.outdir, "validation.txt")) as f:
        for line in f:
            p = line.split()
            val_curve.append((int(p[0]), float(p[2])))
    prec = None
    with open(os.path.join(tr.outdir, "precision.txt")) as f:
        for line in f:
            p = line.split()
            prec = (float(p[1]), float(p[2]))
    tr.close()

    res = {
        "variant": variant, "k": k, "n": N, "m": M,
        "nnz": int(store.coo_y.size),
        "wall_s": round(wall, 1),
        "compile_s": round(compile_s, 1),
        "iterations": int(iters),
        "s_per_iter_incl_eval": round(wall / max(iters, 1), 4),
        "final_validation_loglik": val_curve[-1][1] if val_curve else None,
        "best_validation_loglik": max(v for _, v in val_curve)
        if val_curve else None,
        "precision_at_10": prec[0] if prec else None,
        "precision_at_100": prec[1] if prec else None,
        "ref_sweep_s_per_iter_same_host": 4.7,
    }
    print(json.dumps(res, indent=1), flush=True)
    out = os.path.join(ROOT, ".bench_cache", "convergence.json")
    with open(out, "w") as f:
        json.dump(res, f)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
