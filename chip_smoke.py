#!/usr/bin/env python
"""Proof that HPF CAVI training runs on the GPU, through its entry points.

Usage:
  python chip_smoke.py          one card: phases a-e below
  python chip_smoke.py --four   four cards: the sharded run of phases b
                                and c (EchoNest with a quarter of its
                                users) beside the same steps on one card,
                                states within 1e-4 under "highest"

Phases (K = 100, the reference presets' full widths, data from seeds):
  a  CLI, ML-1M preset: 6040 x 3681, about 1M nonzeros written as TSV;
     `python -m hgaprec_jax.cli -k 100 -hier -logl -rfreq 5
     -max-iterations 10` run in this process through cli.main; checks
     the output-file contract, a finite validation likelihood and a
     training ELBO that does not decrease.
  b  Netflix preset, dense path: 480189 x 17770 u8 counts built on the
     device (about 9.8 GB); 10 fused HPF steps at matmul precision
     "highest" and "default", with and without -bias; finite state.
  c  EchoNest preset, hybrid path: 1019318 x 384546, about 45M zipf(1.2)
     nonzeros; 5 fused HPF steps through the dense head and the sparse
     tail.
  d  The sweep kernels against plain references at real widths: the
     dense sweep on a 16384-user slice of phase b against f64 NumPy; the
     hybrid sweep on the whole phase-c stream against the chunked
     segment sweep at "highest", and on a 2M-nonzero user slice against
     the log-space segment sweep. Bounds: 1e-4 relative under "highest"
     (summation order only), 2e-2 under "default" (bf16 operands);
     denominator max(|ref|, 1e-3).
  e  The tests marked `gpu` (tests/test_dense_gpu.py), run in this
     process.

Each phase prints one line; the card's name and power limit come first.
The last line is one JSON object with the device as JAX reports it. Any
failed phase, or a backend other than the GPU, ends with a non-zero exit
and no JSON line. Times printed are information, not a benchmark.
"""

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 100
ML_N, ML_M = 6040, 3681
NF_N, NF_M = 480189, 17770
EN_N, EN_M, EN_DRAWS = 1019318, 384546, 85_000_000
DENSE_ROWS = 16384            # phase d's user slice of the Netflix block
SLICE_NNZ = 2_000_000         # phase d's user slice of the EchoNest stream
FOUR_EN_N, FOUR_EN_DRAWS = EN_N // 4, EN_DRAWS // 4   # --four's EchoNest
HIGHEST_TOL, DEFAULT_TOL = 1e-4, 2e-2


def require_gpu():
    """Stop unless JAX runs on a GPU: its silent fallback to the CPU
    must never pass for a run on the card."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, "
                         "not 'gpu'")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


class CooStore:
    """The part of data.ratings.RatingsStore that the device builders
    read, for synthetic streams too large for per-id maps."""
    local_user_rows = None

    def __init__(self, n, m, u, i, y):
        self.n, self.m = n, m
        self.coo_u, self.coo_i, self.coo_y = u, i, y


def rel_err(got, ref) -> float:
    import numpy as np
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)))


def finite(state) -> bool:
    import jax
    import numpy as np
    return all(bool(np.isfinite(np.asarray(x)).all())
               for x in jax.tree.leaves(state))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def run_steps(cfg, data, n_steps, seed=1):
    """init_state + the engine's fused multi-step (models/step.py), timed:
    the first call compiles, the second is the steady state. Returns the
    state after the first n_steps (on the host) and the timings; the
    second dispatch only times, so that comparisons see n_steps."""
    import jax
    from hgaprec_jax.models.state import init_state
    from hgaprec_jax.models.step import make_multi_step
    multi = make_multi_step(cfg)
    state = init_state(cfg, seed=seed)
    t0 = time.perf_counter()
    state = jax.block_until_ready(multi(state, data, n_steps))
    first = time.perf_counter() - t0
    kept = jax.device_get(state)
    t0 = time.perf_counter()
    state = jax.block_until_ready(multi(state, data, n_steps))
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    check(finite(state), "non-finite state")
    return kept, {"compile_and_first_s": round(first, 3),
                  "ms_per_step": round(ms, 3)}


def f64_reference(sweep_fn, args, data):
    """A plain jnp sweep on f64 copies of the factors, under "highest".
    In f32 the reference would carry its own error: a popular item sums
    about a million terms in the arbitrary order of the scatter's
    atomics, up to 1e-3 relative on the card, which is the bound under
    test. In f64 that error is far below it."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        args = [None if x is None else jnp.asarray(x, jnp.float64)
                for x in args]
        return [np.asarray(x) for x in jax.jit(sweep_fn)(*args, data)
                if x is not None]


def elog_factors(n, m, seed):
    """Seeded log-expectations in the range a trained model reaches."""
    import jax
    ka, kb, kc, kd = jax.random.split(jax.random.PRNGKey(seed), 4)
    return (0.3 * jax.random.normal(ka, (n, K)) - 1.0,
            0.3 * jax.random.normal(kb, (m, K)) - 1.0,
            0.3 * jax.random.normal(kc, (n,)) - 2.0,
            0.3 * jax.random.normal(kd, (m,)) - 2.0)


# -- phases -----------------------------------------------------------------

def phase_a(scratch):
    import numpy as np
    from hgaprec_jax import cli
    from hgaprec_jax.data.synthetic import write_pf_dataset
    data_dir = os.path.join(scratch, "ml1m")
    out_dir = os.path.join(scratch, "ml1m_out")
    t0 = time.perf_counter()
    nnz = write_pf_dataset(data_dir, np.random.default_rng(20260817),
                           ML_N, ML_M, k=8, scale=0.7, a=0.3, ap=1.8, b=0.3)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = cli.main(["-dir", data_dir, "-n", str(ML_N), "-m", str(ML_M),
                   "-k", str(K), "-hier", "-logl", "-rfreq", "5",
                   "-max-iterations", "10", "-outdir", out_dir])
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli.main returned {rc}")
    for f in ("validation.txt", "precision.txt", "ranking.tsv", "logl.txt",
              "model.npz", "htheta.tsv", "hbeta.tsv", "thetarate.tsv",
              "betarate.tsv"):
        path = os.path.join(out_dir, f)
        check(os.path.exists(path) and os.path.getsize(path) > 0,
              f"missing or empty {f}")
    with open(os.path.join(out_dir, "validation.txt")) as fh:
        vlik = [float(line.split()[2]) for line in fh if line.strip()]
    with open(os.path.join(out_dir, "logl.txt")) as fh:
        elbo = [float(line) for line in fh if line.strip()]
    check(vlik and np.isfinite(vlik).all(), f"validation likelihood {vlik}")
    # CAVI never lowers the ELBO; the slack covers f32 summation order
    check(len(elbo) >= 2 and all(b >= a - 1e-6 * abs(a)
                                 for a, b in zip(elbo, elbo[1:])),
          f"training ELBO decreased: {elbo}")
    return {"nnz": nnz, "data_s": round(setup, 3), "cli_s": round(wall, 3),
            "validation_loglik": vlik, "elbo": elbo}


def phase_b():
    import jax
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.device import dense_only_data
    from hgaprec_jax.data.synthetic import dense_counts_on_device
    t0 = time.perf_counter()
    dense, nnz = dense_counts_on_device(NF_N, NF_M)
    jax.block_until_ready(dense)
    out = {"nnz": nnz, "y_shape": list(dense.shape),
           "data_s": round(time.perf_counter() - t0, 3)}
    data = dense_only_data(dense)
    for prec in ("highest", "default"):
        for bias in (False, True):
            cfg = ModelConfig(n=NF_N, m=NF_M, k=K, variant="hpf",
                              sweep="dense", bias=bias,
                              matmul_precision=prec)
            state, t = run_steps(cfg, data, 10)
            check(finite(state), f"non-finite state {prec} bias={bias}")
            out[f"{prec}{'_bias' if bias else ''}"] = t
    return out, dense


def zipf_store(n=None, draws=None):
    from hgaprec_jax.data.synthetic import zipf_coo
    n, draws = n or EN_N, draws or EN_DRAWS
    return CooStore(n, EN_M, *zipf_coo(n, EN_M, draws))


def phase_c():
    import jax
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.device import build_device_data
    from hgaprec_jax.models.step import _resolve_mode
    t0 = time.perf_counter()
    store = zipf_store()
    cfg = ModelConfig(n=EN_N, m=EN_M, k=K, variant="hpf")
    data = build_device_data(store, hybrid_head_items=cfg.hybrid_head_items,
                             dense_limit_bytes=cfg.dense_limit_bytes,
                             head_limit_bytes=cfg.head_limit_bytes)
    jax.block_until_ready(data)
    out = {"nnz": int(store.coo_u.size),
           "head_shape": list(data.head_dense_y.shape),
           "tail_nnz": int((data.y_tail > 0).sum()),
           "data_s": round(time.perf_counter() - t0, 3)}
    check(_resolve_mode(cfg, data) == "hybrid", "hybrid mode not chosen")
    state, t = run_steps(cfg, data, 5)
    check(finite(state), "non-finite state")
    out.update(t)
    return out, store, data


def phase_d(dense, store, data_c):
    import jax
    import numpy as np
    from hgaprec_jax.data.device import build_device_data, dense_only_data
    from hgaprec_jax.ops.sweep import (select_kernels, sweep,
                                       sweep_segment, sweep_segment_chunked)
    out = {}
    for prec in ("highest", "default"):
        out[f"kernels_{prec}"] = select_kernels(
            jax.default_backend(), "hybrid", k=K, bias=True,
            precision=prec, compact_tail=data_c.tail_compact is not None
        )._asdict()
    check(out["kernels_default"]["block"] == "fused",
          "the fused dense kernel is not selected on this backend")
    run = jax.jit(sweep, static_argnames=("mode", "precision"))
    tol = {"highest": HIGHEST_TOL, "default": DEFAULT_TOL}

    # dense: a 16384-user slice of the Netflix block, full M, K = 100
    rows = DENSE_ROWS
    y = dense[:rows]
    ea, eb, eba, ebb = elog_factors(rows, NF_M, 3)
    a, b, ba, bb = (np.exp(np.asarray(x, np.float64))
                    for x in (ea, eb, eba, ebb))
    yh = np.asarray(y[:, :NF_M], np.float64)
    for bias in (False, True):
        s = a @ b.T + ((ba[:, None] + bb[None, :]) if bias else 0.0)
        w = np.where(yh > 0, yh / s, 0.0)
        ref = [a * (w @ b), b * (w.T @ a)]
        if bias:
            ref += [ba * w.sum(1), bb * w.sum(0)]
        for prec in ("highest", "default"):
            got = run(ea, eb, eba if bias else None, ebb if bias else None,
                      dense_only_data(y), mode="dense", precision=prec)
            err = max(rel_err(g, r) for g, r in zip(got, ref))
            key = f"dense_{prec}{'_bias' if bias else ''}"
            out[key] = err
            check(err <= tol[prec], f"{key}: {err:.3g} > {tol[prec]}")
        del s, w, ref

    # hybrid, whole stream: against the chunked segment sweep
    ea, eb, eba, ebb = elog_factors(EN_N, EN_M, 4)
    for bias in (False, True):
        args = (ea, eb, eba if bias else None, ebb if bias else None)
        ref = f64_reference(sweep_segment_chunked, args, data_c)
        for prec in ("highest", "default"):
            got = run(*args, data_c, mode="hybrid", precision=prec)
            err = max(rel_err(g, r) for g, r in zip(got, ref))
            key = f"hybrid_{prec}{'_bias' if bias else ''}"
            out[key] = err
            check(err <= tol[prec], f"{key}: {err:.3g} > {tol[prec]}")

    # hybrid on a 2M-nonzero user slice: against the log-space sweep
    users = int(store.coo_u[SLICE_NNZ])
    sel = store.coo_u < users
    part = CooStore(users, EN_M, store.coo_u[sel], store.coo_i[sel],
                    store.coo_y[sel])
    seg = build_device_data(part, dense=False)
    hyb = build_device_data(part, dense=False, hybrid_head_items=8192)
    args = (ea[:users], eb, eba[:users], ebb)
    ref = f64_reference(sweep_segment, args, seg)
    for prec in ("highest", "default"):
        got = run(*args, hyb, mode="hybrid", precision=prec)
        err = max(rel_err(g, r) for g, r in zip(got, ref))
        out[f"slice_{prec}_bias"] = err
        check(err <= tol[prec], f"slice {prec}: {err:.3g} > {tol[prec]}")
    out["slice_nnz"] = int(sel.sum())
    return out


def phase_e():
    import pytest

    class Tally:
        def __init__(self):
            self.counts = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.counts[report.outcome] += 1

    os.environ["HGAPREC_TEST_GPU"] = "1"
    tally = Tally()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_dense_gpu.py")],
                     plugins=[tally])
    c = tally.counts
    check(rc == 0 and c["passed"] > 0 and not c["failed"] and
          not c["skipped"], f"gpu tests: rc={rc} {c}")
    return c


# -- four cards -------------------------------------------------------------

def netflix_store(dense):
    """The phase-b matrix as a host COO stream, for the sharded builder.
    The nonzeros are found on the device, one 4096-row block (the
    generator's row padding) at a time, so only the stream crosses."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    step = 4096
    per_row = jax.jit(lambda d: jnp.sum(d[:, :NF_M] > 0, axis=1,
                                        dtype=jnp.int32))(dense)
    counts = np.asarray(per_row).reshape(-1, step).sum(axis=1)
    cap = int(counts.max())

    @jax.jit
    def block(d, lo):
        blk = jax.lax.dynamic_slice_in_dim(d, lo, step, 0)[:, :NF_M]
        r, c = jnp.nonzero(blk, size=cap)
        return r + lo, c, blk[r, c]

    parts = [jax.device_get(block(dense, lo)) + (int(c),)
             for lo, c in zip(range(0, dense.shape[0], step), counts)]
    u, i, y = (np.concatenate([p[j][:p[3]] for p in parts]).astype(dt)
               for j, dt in ((0, np.int32), (1, np.int32), (2, np.float32)))
    return CooStore(NF_N, NF_M, u, i, y)


def compare_sharded(name, store, cfg, n_steps, one):
    """The user-row sharded run over four cards (parallel/sharded.py, as
    `-devices 4` drives it) against `one`, the host state after the same
    n_steps on one card."""
    import jax
    from hgaprec_jax.parallel.sharded import build_sharded_run, make_mesh
    mesh = make_mesh(jax.devices()[:4])
    t0 = time.perf_counter()
    run = build_sharded_run(store, cfg, mesh, seed=1)
    out = {"four_data_s": round(time.perf_counter() - t0, 3)}
    user_devs = {s.device for s in run.state.theta.e.addressable_shards}
    check(len(user_devs) == 4, f"{name}: user rows on {user_devs}")
    for leaf in (run.data.dense_y, run.data.head_dense_y):
        if leaf is not None:
            check(len({s.device for s in leaf.addressable_shards}) == 4,
                  f"{name}: data rows not on four devices")
    t0 = time.perf_counter()
    jax.block_until_ready(run.multi_step(n_steps))
    first = time.perf_counter() - t0
    four = run.unsharded_state()
    t0 = time.perf_counter()
    jax.block_until_ready(run.multi_step(n_steps))
    out["four"] = {"compile_and_first_s": round(first, 3),
                   "ms_per_step": round((time.perf_counter() - t0)
                                        / n_steps * 1e3, 3)}
    check(finite(four), f"{name}: non-finite sharded state")
    errs = {fam: rel_err(getattr(four, fam).e, getattr(one, fam).e)
            for fam in ("theta", "beta", "theta_rate", "beta_rate")}
    out["state_rel_err"] = errs
    check(max(errs.values()) <= HIGHEST_TOL,
          f"{name}: sharded vs one card {errs}")
    return out


def phase_four():
    """Phases b and c at "highest" on one card, then sharded over four.
    EchoNest keeps its catalog and K but a quarter of its users here."""
    import jax
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.device import build_device_data, dense_only_data
    from hgaprec_jax.data.synthetic import dense_counts_on_device
    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices")
    res = {}

    cfg = ModelConfig(n=NF_N, m=NF_M, k=K, variant="hpf", sweep="dense")
    t0 = time.perf_counter()
    dense, _ = dense_counts_on_device(NF_N, NF_M)
    one, t = run_steps(cfg, dense_only_data(dense), 10)
    store = netflix_store(dense)
    del dense
    res["netflix"] = {"nnz": int(store.coo_u.size), "one": t,
                      "data_s": round(time.perf_counter() - t0, 3)}
    res["netflix"].update(compare_sharded("netflix", store, cfg, 10, one))
    del store

    t0 = time.perf_counter()
    store = zipf_store(FOUR_EN_N, FOUR_EN_DRAWS)
    cfg = ModelConfig(n=store.n, m=store.m, k=K, variant="hpf")
    data = build_device_data(store, hybrid_head_items=cfg.hybrid_head_items,
                             dense_limit_bytes=cfg.dense_limit_bytes,
                             head_limit_bytes=cfg.head_limit_bytes)
    res["echonest"] = {"n": store.n, "nnz": int(store.coo_u.size),
                       "data_s": round(time.perf_counter() - t0, 3)}
    one, res["echonest"]["one"] = run_steps(cfg, data, 5)
    del data
    res["echonest"].update(compare_sharded("echonest", store, cfg, 5, one))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()
    require_gpu()
    sys.path.insert(0, ROOT)
    try:
        from hgaprec_jax.compile_cache import configure_compile_cache
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the hgaprec_jax package is not "
                         f"beside this script ({e})")
    configure_compile_cache()
    import jax
    print(f"card: {card_line()}", flush=True)

    failed = []

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
            res = fn(*a)
        except Exception as e:   # report, then fail the run at the end
            failed.append(name)
            print(f"phase {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f}s: "
                  f"{type(e).__name__}: {e}", flush=True)
            return None
        line = res[0] if isinstance(res, tuple) else res
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s "
              f"{json.dumps(line)}", flush=True)
        return res

    if args.four:
        phase("four", phase_four)
    else:
        scratch = os.path.join(ROOT, "out", "chip_smoke")
        shutil.rmtree(scratch, ignore_errors=True)
        os.makedirs(scratch)
        phase("a", phase_a, scratch)
        b = phase("b", phase_b)
        c = phase("c", phase_c)
        if b is None or c is None:
            failed.append("d")
            print("phase d: FAILED: needs phases b and c", flush=True)
        else:
            phase("d", phase_d, b[1], c[1], c[2])
        b = c = None
        phase("e", phase_e)
        shutil.rmtree(scratch, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        sys.exit(1)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
