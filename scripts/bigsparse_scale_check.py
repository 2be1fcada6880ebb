#!/usr/bin/env python
"""Big-sparse scale check: EchoNest / NYT-preset shapes on one device.

A dense u8 stream is impossible at these shapes (EchoNest 1019318 x
384546 is about 392 GB dense), so training runs the hybrid head/tail
layout (dense top-degree items through the dense kernel + the sparse
tail) or the chunked segment sweep. This harness builds a synthetic COO
stream at preset scale (data/synthetic.py::zipf_coo), lays it out as the
Trainer does (data/device.py::build_device_data), times the fused HPF
step per configuration, the two sparse tails alone, and the streamed
itemrank eval, and writes .bench_cache/<preset>_scale.json.

Usage: python scripts/bigsparse_scale_check.py [echonest|nyt]
           [draws_millions] [head_gib] [segment]
  `segment` also times the chunked segment sweep on the whole stream.
"""

import dataclasses
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# run.pl presets (scripts/run.pl:84-87, 158-161)
PRESETS = {
    "echonest": (1019318, 384546),
    "nyt": (1615675, 107523),
}
K = 100
CHUNK = 5


class CooStore:
    """What build_device_data reads from a RatingsStore."""
    local_user_rows = None

    def __init__(self, n, m, u, i, y):
        self.n, self.m = n, m
        self.coo_u, self.coo_i, self.coo_y = u, i, y


def time_steps(cfg, data, dispatches=2):
    """The engine's dispatch shape: CHUNK iterations fused in one
    program (models/engine.py fuses rfreq iterations per dispatch)."""
    from hgaprec_jax.models.state import init_state
    from hgaprec_jax.models.step import make_multi_step
    multi = make_multi_step(cfg)
    state = init_state(cfg, seed=1)
    t0 = time.perf_counter()
    state = jax.block_until_ready(multi(state, data, CHUNK))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(dispatches):
        state = multi(state, data, CHUNK)
    jax.block_until_ready(state)
    ms = (time.perf_counter() - t0) / (dispatches * CHUNK) * 1e3
    if not np.isfinite(np.asarray(state.theta.e)).all():
        raise FloatingPointError("non-finite state")
    return ms, compile_s, state


def time_fn(fn, *args, reps=5):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def tail_timings(data, a_lin, b_lin):
    """ms of one sweep over the tail alone: the compact two-pass sweep
    (ops/mxu_tail.py) against the one-pass COO sweep, both sides summed
    so that neither half can be dropped as dead code."""
    from hgaprec_jax.ops.mxu_tail import mxu_tail_sweep
    from hgaprec_jax.ops.sweep import SEGMENT_CHUNK, _segment_onepass_lin

    @functools.partial(jax.jit, static_argnames=("bf16",))
    def mxu(a, b, tc, bf16):
        ra, rb, _, _ = mxu_tail_sweep(a, b, None, None, tc, bf16=bf16)
        return jnp.sum(ra) + jnp.sum(rb)

    @jax.jit
    def onepass(a, b, u, i, y):
        r = _segment_onepass_lin(a, b, None, None, u, i, y, SEGMENT_CHUNK)
        return jnp.sum(r.acc_a) + jnp.sum(r.acc_b)

    out = {}
    for bf16 in (True, False):
        out[f"tail_mxu_ms_{'bf16' if bf16 else 'f32'}"] = time_fn(
            functools.partial(mxu, bf16=bf16), a_lin, b_lin,
            data.tail_compact)
    out["tail_onepass_ms"] = time_fn(onepass, a_lin, b_lin, data.u_ids_tail,
                                     data.i_ids_tail, data.y_tail)
    return out


def main():
    from hgaprec_jax.compile_cache import configure_compile_cache
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.device import build_device_data
    from hgaprec_jax.data.synthetic import zipf_coo
    from hgaprec_jax.eval.score import scorer_from_state
    from hgaprec_jax.eval.topk import item_ranks

    configure_compile_cache()
    preset = sys.argv[1] if len(sys.argv) > 1 else "echonest"
    draws_m = float(sys.argv[2]) if len(sys.argv) > 2 else 85.0
    head_gib = float(sys.argv[3]) if len(sys.argv) > 3 else 4.0
    segment = "segment" in sys.argv[4:]
    n, m = PRESETS[preset]

    t0 = time.perf_counter()
    u, i, y = zipf_coo(n, m, int(draws_m * 1e6))
    store = CooStore(n, m, u, i, y)
    cfg = ModelConfig(n=n, m=m, k=K, variant="hpf",
                      head_limit_bytes=int(head_gib * (1 << 30)))
    data = build_device_data(store, hybrid_head_items=cfg.hybrid_head_items,
                             dense_limit_bytes=cfg.dense_limit_bytes,
                             head_limit_bytes=cfg.head_limit_bytes)
    jax.block_until_ready(data)
    results = {"preset": preset, "n": n, "m": m, "k": K, "nnz": int(u.size),
               "distribution": "user power(3.0), item zipf(1.2), dedup",
               "head_T": int(data.head_items.shape[0]),
               "tail_nnz": int((data.y_tail > 0).sum()),
               "data_s": time.perf_counter() - t0,
               "iters_per_dispatch": CHUNK,
               "device_kind": jax.devices()[0].device_kind}
    print(json.dumps(results), flush=True)

    state = None
    for prec, tag in (("default", "hybrid_bf16"), ("highest", "hybrid_f32")):
        state = None      # free the previous state before the next one
        ms, compile_s, state = time_steps(
            dataclasses.replace(cfg, matmul_precision=prec), data)
        results[f"ms_per_iter_{tag}"] = ms
        results[f"compile_s_{tag}"] = compile_s
        print(f"{tag}: {ms:.3f} ms/iter", flush=True)
    if segment:
        seg = dataclasses.replace(cfg, sweep="segment-chunked",
                                  matmul_precision="default")
        results["ms_per_iter_segment"], _, _ = time_steps(seg, data)

    sc = scorer_from_state(state, cfg)
    state = None
    results.update(tail_timings(data, sc.su, sc.sv))

    # streamed ranking eval: 1000 (user, item) pairs among all M items
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(u, minlength=n))]).astype(np.int64)

    class StoreShim:
        def __init__(self):
            self.m, self.n = m, n

        def items_of_user(self, nn):
            return i[row_ptr[nn]:row_ptr[nn + 1]].astype(np.int64)

    class IndexShim:
        @staticmethod
        def val_items(nn):
            return np.zeros(0, np.int64)

    rng = np.random.default_rng(3)
    pairs_u, pairs_i = rng.integers(0, n, 1000), rng.integers(0, m, 1000)
    for label in ("itemrank_1000pairs_cold_s", "itemrank_1000pairs_warm_s"):
        t0 = time.perf_counter()
        ranks, _ = item_ranks(sc, StoreShim(), IndexShim(), pairs_u, pairs_i)
        results[label] = time.perf_counter() - t0
    assert int(ranks.min()) >= 0 and int(ranks.max()) < m

    out = os.path.join(ROOT, ".bench_cache", f"{preset}_scale.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
        fh.write("\n")
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
