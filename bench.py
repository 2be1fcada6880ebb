#!/usr/bin/env python
"""Benchmark: HPF K=100 CAVI on MovieLens-1M-scale synthetic data.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

value        = CAVI iterations/second on the available accelerator
vs_baseline  = speedup over a single-threaded C++ restatement of the
               reference's per-nonzero sweep (the reference itself needs
               GSL, absent here; native/ref_cavi_bench.cc reproduces its
               computational pattern: double-precision scalar loops,
               log-chain normalization, digamma expectations). The
               reference preset is MovieLens N=6040 M=3681 K=100
               (scripts/run.pl:109-112).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench_cache")
N, M, K = 6040, 3681, 100
SEED = 20260817
TIMED_ITERS = 200
REF_ITERS = 2


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def get_dataset():
    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, f"ml1m_{N}x{M}_{SEED}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return z["u"], z["i"], z["y"]
    from hgaprec_jax.data.synthetic import generate_pf_counts
    rng = np.random.default_rng(SEED)
    # tuned for ~1M nonzeros at 6040x3681 (ML-1M density ~4.5%)
    u, i, y = generate_pf_counts(rng, N, M, k=8, a=0.3, ap=1.8, b=0.3,
                                 scale=0.7)
    np.savez_compressed(path, u=u, i=i, y=y)
    return u, i, y


def build_store(u, i, y):
    from hgaprec_jax.data.ratings import RatingsStore
    store = RatingsStore(N, M)
    # vectorized ingest: ids are already dense/contiguous
    store.user2seq = {int(x): int(x) for x in range(N)}
    store.seq2user = dict(store.user2seq)
    store.movie2seq = {int(x): int(x) for x in range(M)}
    store.seq2movie = dict(store.movie2seq)
    store._u = list(u)
    store._i = list(i)
    store._y = list(np.minimum(y, 255))
    store.finalize()
    return store


def time_device(store):
    import jax
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.device import build_device_data
    from hgaprec_jax.models.state import init_state
    from hgaprec_jax.models.step import make_multi_step

    platform = jax.devices()[0].platform
    log(f"device: {jax.devices()[0]} ({platform})")
    # bf16 matmuls / f32 state: the serving config (tests/test_step_golden
    # covers exact math at "highest")
    cfg = ModelConfig(n=store.n, m=store.m, k=K, variant="hpf",
                      sweep="dense", matmul_precision="default")
    data = build_device_data(store, pad_multiple=4096)
    state = init_state(cfg, seed=1)
    # rfreq iterations per dispatch, exactly as the training engine runs
    # between two reporting points (models/engine.py::_run_loop); the
    # engine only dispatches the fused multi-step, so only it compiles
    multi = make_multi_step(cfg)
    chunk = 10
    t0 = time.time()
    state = jax.block_until_ready(multi(state, data, chunk))
    log(f"compile+first fused chunk: {time.time() - t0:.2f}s")
    state = jax.block_until_ready(multi(state, data, chunk))

    def timed_window(state):
        t0 = time.time()
        for _ in range(TIMED_ITERS // chunk):
            state = multi(state, data, chunk)
        jax.block_until_ready(state)
        return state, (time.time() - t0) / (TIMED_ITERS // chunk * chunk)

    windows = []
    for _ in range(3):
        state, dt = timed_window(state)
        windows.append(dt)
    dt = min(windows)
    log(f"{platform}: {dt * 1e3:.3f} ms/iter ({chunk} iters/dispatch; "
        f"window spread {min(windows) * 1e3:.3f}-"
        f"{max(windows) * 1e3:.3f} ms)")
    return dt, platform


def time_reference(store):
    exe = os.path.join(CACHE, "ref_cavi_bench")
    src = os.path.join(ROOT, "native", "ref_cavi_bench.cc")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        log("compiling C++ baseline...")
        subprocess.check_call(["g++", "-O3", "-march=native", "-o", exe, src])
    data_bin = os.path.join(CACHE, f"ml1m_{SEED}.bin")
    if not os.path.exists(data_bin):
        with open(data_bin, "wb") as f:
            np.asarray([store.n, store.m, K, store.coo_y.size],
                       np.int64).tofile(f)
            store.row_ptr.astype(np.int64).tofile(f)
            store.coo_i.astype(np.int32).tofile(f)
            store.coo_y.astype(np.float32).tofile(f)
    t0 = time.time()
    out = subprocess.check_output([exe, data_bin, str(REF_ITERS)],
                                  text=True)
    log(f"ref total: {time.time() - t0:.1f}s -> {out.strip()}")
    return float(out.split()[1])


def netflix_numbers():
    """Netflix-preset (480189 x 17770, K=100) ms/iter, in this process."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from netflix_scale_check import netflix_timings
    z = netflix_timings(("bf16", "bf16_bias"))
    return {
        "netflix_hpf_ms_per_iter_bf16": z["ms_per_iter_bf16"],
        "netflix_hpf_ms_per_iter_bf16_bias": z["ms_per_iter_bf16_bias"],
    }


def main():
    u, i, y = get_dataset()
    log(f"dataset: {N}x{M}, nnz={u.size}")
    store = build_store(u, i, y)
    from hgaprec_jax.compile_cache import configure_compile_cache
    configure_compile_cache()
    t_dev, platform = time_device(store)
    t_ref = time_reference(store)
    result = {
        "metric": f"hpf_cavi_ml1m_k{K}_iters_per_sec_{platform}",
        "value": round(1.0 / t_dev, 3),
        "unit": "iter/s",
        "vs_baseline": round(t_ref / t_dev, 2),
    }
    result.update(netflix_numbers())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
