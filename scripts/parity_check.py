"""Parity harness: the REAL reference binary vs this JAX implementation.

BASELINE.md:31-48 acceptance: on an ML-1M-scale dataset (N=6040, M=3681,
K=100), for each config (BPF, BPF -binary-data, BPF -bias, HPF -hier), run
both stacks and compare:
  1. validation predictive log-likelihood vs iteration / wall-clock
     (validation.txt: iter\tsecs\tavg\tcount — hgaprec.cc:1469);
  2. final precision@10/@100 (precision.txt — hgaprec.cc:1838-1841);
  3. training ELBO trajectory (-logl, logl.txt — hgaprec.cc:2160-2255),
     monotone non-decreasing on both sides;
  4. time-to-convergence under the stopping rule (hgaprec.cc:1476-1491).

The reference is built from /root/reference/src with a local GSL shim
(refbuild/gslshim — GSL is not installed in this image); the dataset is
synthetic HPF-generative data at the MovieLens-1M preset shape
(scripts/run.pl:109-112) because the image ships no datasets and has no
network egress.

Usage:
  python scripts/parity_check.py gen            # write the shared dataset
  python scripts/parity_check.py build          # build the reference binary
  python scripts/parity_check.py ref  <cfg>     # run reference on <cfg>
  python scripts/parity_check.py ours <cfg>     # run this implementation on <cfg>
  python scripts/parity_check.py report         # compare + write artifacts
cfg in {bpf, bpfbin, bpfbias, hpf}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache", "parity")
DATA = os.path.join(CACHE, "data")
REF_BIN = os.path.join(ROOT, "refbuild", "hgaprec_ref")

N, M, K = 6040, 3681, 100
SCALE = 0.7          # tuned so nnz ~= 1.0M (the ML-1M ratings count)
SEED = 42
MAXIT = 500          # vb_hier honors it; vb() relies on the stopping rule
TIMEOUT = 5400

CONFIGS = {
    "bpf": [],
    "bpfbin": ["-binary-data"],
    "bpfbias": ["-bias"],
    "hpf": ["-hier"],
}


def flags(cfg):
    return ["-dir", DATA, "-n", str(N), "-m", str(M), "-k", str(K),
            "-rfreq", "10", "-logl", "-seed", "1",
            "-max-iterations", str(MAXIT), "-label", cfg] + CONFIGS[cfg]


def gen():
    import numpy as np
    sys.path.insert(0, ROOT)
    from hgaprec_jax.data.synthetic import write_pf_dataset
    rng = np.random.default_rng(SEED)
    nnz = write_pf_dataset(DATA, rng, N, M, k=5, scale=SCALE)
    print(f"wrote {DATA}: nnz={nnz}")


def build():
    """Build the reference binary against the GSL shim.

    ratings.cc must be compiled at -O0: four of its int functions fall off
    the end without a return (ratings.cc:60, 151, 271, 790), which is UB in
    C++ — at -O2/-O3 GCC drops the function epilogue and control slides
    into adjacent code (observed as a double-free crash during read()).
    The hot inference loop lives in hgaprec.cc/gpbase.hh, which compile
    clean at -O3, so this does not distort the performance comparison.
    """
    rb = os.path.join(ROOT, "refbuild")
    os.makedirs(rb, exist_ok=True)
    src = "/root/reference/src"
    inc = ["-I", os.path.join(rb, "gslshim")]

    def cc(opt, out, *srcs):
        subprocess.run(["g++", opt, "-std=c++11", "-w"] + inc +
                       ["-c", "-o", out] + list(srcs), check=True)

    cc("-O0", f"{rb}/ratings.o", f"{src}/ratings.cc")
    for f in ("main", "log", "hgaprec"):
        cc("-O3", f"{rb}/{f}.o", f"{src}/{f}.cc")
    cc("-O3", f"{rb}/gslshim.o", os.path.join(rb, "gslshim", "gslshim.cc"))
    subprocess.run(["g++", "-O3", "-o", REF_BIN] +
                   [f"{rb}/{f}.o" for f in
                    ("main", "ratings", "log", "hgaprec", "gslshim")] +
                   ["-lpthread"], check=True)
    print(f"built {REF_BIN}")


def _run(cmd, cwd):
    os.makedirs(cwd, exist_ok=True)
    t0 = time.time()
    with open(os.path.join(cwd, "run.out"), "w") as out:
        p = subprocess.run(cmd, cwd=cwd, stdout=out, stderr=subprocess.STDOUT,
                           timeout=TIMEOUT)
    dt = time.time() - t0
    print(f"exit={p.returncode} wall={dt:.1f}s cwd={cwd}")
    return dt


def run_ref(cfg):
    # The reference creates its output dir under the cwd (env.hh:283-369).
    return _run([REF_BIN] + flags(cfg), os.path.join(CACHE, "ref", cfg))


def run_ours(cfg):
    env = dict(os.environ)
    # append, don't clobber any PYTHONPATH entries already set
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cwd = os.path.join(CACHE, "ours", cfg)
    os.makedirs(cwd, exist_ok=True)
    t0 = time.time()
    cmd = [sys.executable, "-m", "hgaprec_jax.cli"] + flags(cfg)
    with open(os.path.join(cwd, "run.out"), "w") as out:
        p = subprocess.run(cmd, cwd=cwd, stdout=out, stderr=subprocess.STDOUT,
                           timeout=TIMEOUT, env=env)
    dt = time.time() - t0
    print(f"exit={p.returncode} wall={dt:.1f}s cwd={cwd}")
    return dt


def _outdir(base):
    """The single run output dir under base (name derives from config)."""
    dirs = [d for d in os.listdir(base)
            if os.path.isdir(os.path.join(base, d))]
    assert len(dirs) == 1, (base, dirs)
    return os.path.join(base, dirs[0])


def _read_tsv(path, ncols):
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= ncols:
                rows.append([float(x) for x in parts[:ncols]])
    return rows


def _curves(outdir):
    val = _read_tsv(os.path.join(outdir, "validation.txt"), 4)
    prec = _read_tsv(os.path.join(outdir, "precision.txt"), 3)
    logl = _read_tsv(os.path.join(outdir, "logl.txt"), 1)
    maxf = _read_tsv(os.path.join(outdir, "max.txt"), 4)
    return {
        "validation": val,            # iter, secs, mean loglik, count
        "precision": prec,            # users, p@10, p@100
        "logl": [r[0] for r in logl],  # one ELBO value per line
        "max": maxf[-1] if maxf else None,
    }


def report():
    out = {}
    for cfg in CONFIGS:
        entry = {}
        for side, base in (("ref", os.path.join(CACHE, "ref", cfg)),
                           ("ours", os.path.join(CACHE, "ours", cfg))):
            if not os.path.isdir(base):
                continue
            try:
                c = _curves(_outdir(base))
            except AssertionError:
                continue
            val = c["validation"]
            elbo = c["logl"]
            mono = all(b >= a - abs(a) * 1e-7
                       for a, b in zip(elbo, elbo[1:])) if elbo else None
            entry[side] = {
                "final_val_loglik": val[-1][2] if val else None,
                "best_val_loglik": max(r[2] for r in val) if val else None,
                "converged_iter": int(val[-1][0]) if val else None,
                "wallclock_s": val[-1][1] if val else None,
                "final_p10": c["precision"][-1][1] if c["precision"] else None,
                "final_p100": c["precision"][-1][2] if c["precision"] else
                              None,
                "elbo_monotone": mono,
                "elbo_final": elbo[-1] if elbo else None,
                "val_curve": [[r[0], r[1], r[2]] for r in val],
                "elbo_curve": elbo,
                "prec_curve": [[r[1], r[2]] for r in c["precision"]],
            }
        out[cfg] = entry
    path = os.path.join(CACHE, "parity.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    for cfg, e in out.items():
        r, o = e.get("ref"), e.get("ours")
        if not (r and o):
            print(f"{cfg}: INCOMPLETE ({list(e)})")
            continue
        print(f"{cfg}: val ref={r['final_val_loglik']:.4f} "
              f"ours={o['final_val_loglik']:.4f} | "
              f"p@10 ref={r['final_p10']:.4f} ours={o['final_p10']:.4f} | "
              f"iters ref={r['converged_iter']} ours={o['converged_iter']} | "
              f"wall ref={r['wallclock_s']:.0f}s ours={o['wallclock_s']:.0f}s"
              f" | elbo mono ref={r['elbo_monotone']} o={o['elbo_monotone']}")


def main():
    cmd = sys.argv[1] if len(sys.argv) > 1 else "report"
    if cmd == "gen":
        gen()
    elif cmd == "build":
        build()
    elif cmd == "ref":
        run_ref(sys.argv[2])
    elif cmd == "ours":
        run_ours(sys.argv[2])
    elif cmd == "report":
        report()
    else:
        raise SystemExit(f"unknown command {cmd}")


if __name__ == "__main__":
    main()
