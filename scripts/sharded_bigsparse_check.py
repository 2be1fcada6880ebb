#!/usr/bin/env python
"""Sharded hybrid big-sparse layout against the unsharded one.

Builds an EchoNest-preset-shaped synthetic store, runs the SHARDED
hybrid path (build_sharded_run over a mesh of every visible device —
the same shard_map program a larger mesh runs, with the collectives
compiled in) and compares per-iteration time against the unsharded
hybrid step on identical data. On one device this shows what the
sharding costs; `python chip_smoke.py --four` checks four.

Scaled-down preset by default (work still dominated by the same head
matmuls + sparse tail); pass `full` for the real preset size.

Writes .bench_cache/sharded_bigsparse.json.
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

K = 100


def build_store(n, m, nnz, seed=5):
    from hgaprec_jax.data.ratings import RatingsStore
    rng = np.random.default_rng(seed)
    u = np.minimum((n * rng.power(3.0, nnz)).astype(np.int64), n - 1)
    i = np.minimum(rng.zipf(1.2, nnz) - 1, m - 1).astype(np.int64)
    key = u * m + i
    order = np.argsort(key, kind="stable")
    key = key[order]
    keep = np.concatenate([[True], key[1:] != key[:-1]])
    u, i = u[order][keep], i[order][keep]
    y = rng.integers(1, 5, u.size)
    store = RatingsStore(n, m)
    store.user2seq = {int(x): int(x) for x in range(n)}
    store.seq2user = dict(store.user2seq)
    store.movie2seq = {int(x): int(x) for x in range(m)}
    store.seq2movie = dict(store.movie2seq)
    store._u = list(u)
    store._i = list(i)
    store._y = list(np.minimum(y, 255))
    store.finalize()
    return store


def main():
    full = "full" in sys.argv[1:]
    if full:
        n, m, nnz = 1019318, 384546, int(77e6)
    else:
        n, m, nnz = 260096, 120000, int(20e6)
    t0 = time.time()
    store = build_store(n, m, nnz)
    print(f"store {time.time() - t0:.0f}s nnz={store.nratings / 1e6:.1f}M",
          flush=True)

    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.device import build_device_data
    from hgaprec_jax.models.state import init_state
    from hgaprec_jax.models.step import (_resolve_mode, cavi_multi_step,
                                         make_multi_step)
    from hgaprec_jax.parallel.sharded import build_sharded_run, make_mesh

    cfg = ModelConfig(n=store.n, m=store.m, k=K, variant="hpf",
                      sweep="auto", matmul_precision="default",
                      dense_limit_bytes=1 << 30)
    results = {"n": n, "m": m, "k": K, "nnz": int(store.nratings),
               "iters_per_dispatch": 5}
    out = os.path.join(ROOT, ".bench_cache", "sharded_bigsparse.json")
    chunk = 5

    # ---- unsharded hybrid baseline --------------------------------------
    data = build_device_data(store, hybrid_head_items=cfg.hybrid_head_items,
                             dense_limit_bytes=cfg.dense_limit_bytes)
    assert _resolve_mode(cfg, data) == "hybrid", _resolve_mode(cfg, data)
    state = init_state(cfg, seed=1)
    multi = make_multi_step(cfg)
    t0 = time.time()
    state = jax.block_until_ready(multi(state, data, chunk))
    print(f"unsharded compile+first {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    for _ in range(2):
        state = multi(state, data, chunk)
    jax.block_until_ready(state)
    ms_un = (time.time() - t0) / (2 * chunk) * 1e3
    print(f"unsharded hybrid: {ms_un:.0f} ms/iter", flush=True)
    results["ms_per_iter_unsharded"] = round(ms_un, 1)
    ref_sum = float(np.asarray(state.theta.e, np.float64).sum())
    del data, state

    # ---- sharded hybrid over every visible device ------------------------
    ndev = len(jax.devices())
    mesh = make_mesh(jax.devices()[:ndev])
    run = build_sharded_run(store, cfg, mesh, seed=1)
    assert run.data.head_dense_y is not None
    assert run.data.tail_compact is not None
    assert _resolve_mode(run.cfg, run.data) == "hybrid"
    t0 = time.time()
    jax.block_until_ready(run.multi_step(chunk))
    print(f"sharded({ndev}) compile+first {time.time() - t0:.1f}s",
          flush=True)
    t0 = time.time()
    for _ in range(2):
        run.multi_step(chunk)
    jax.block_until_ready(run.state)
    ms_sh = (time.time() - t0) / (2 * chunk) * 1e3
    print(f"sharded({ndev}-device mesh) hybrid: {ms_sh:.0f} ms/iter "
          f"({ms_sh / ms_un:.2f}x unsharded)", flush=True)
    results["devices"] = ndev
    results["ms_per_iter_sharded"] = round(ms_sh, 1)
    results["sharded_over_unsharded"] = round(ms_sh / ms_un, 3)
    # trajectory parity (identical seeds; f32 summation order may differ)
    st = run.unsharded_state("eval")
    got_sum = float(np.asarray(st.theta.e, np.float64).sum())
    rel = abs(got_sum - ref_sum) / abs(ref_sum)
    results["state_rel_diff"] = rel
    print(f"state rel diff after {3 * chunk} iters: {rel:.2e}", flush=True)
    assert rel < 5e-3
    results["device_kind"] = jax.devices()[0].device_kind
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
        fh.write("\n")
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
