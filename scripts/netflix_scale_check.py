#!/usr/bin/env python
"""Netflix-preset scale check: one-device HPF K=100 at 480189 x 17770.

Everything stays on the device: the synthetic count matrix is sampled
with jax.random directly into a u8 [N, M] buffer (about 9.8 GB,
data/synthetic.py::dense_counts_on_device), then the engine's fused
multi-step (rfreq = 10 iterations per dispatch, as models/engine.py runs
between two reports) is timed at f32 ("highest") and bf16 ("default")
matmul precision, with and without biases.

Usage: python scripts/netflix_scale_check.py [tag,tag,...]
  tags: bf16 f32 bf16_bias f32_bias (default: all)
Writes .bench_cache/netflix_scale.json and prints it.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

N, M, K = 480189, 17770, 100
CHUNK = 10
CONFIGS = {"bf16": ("default", False), "f32": ("highest", False),
           "bf16_bias": ("default", True), "f32_bias": ("highest", True)}


def netflix_timings(tags=tuple(CONFIGS), dispatches: int = 3) -> dict:
    """ms per iteration for each tag, plus the data's shape and nnz."""
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.device import dense_only_data
    from hgaprec_jax.data.synthetic import dense_counts_on_device
    from hgaprec_jax.models.state import init_state
    from hgaprec_jax.models.step import make_multi_step

    t0 = time.perf_counter()
    dense, nnz = dense_counts_on_device(N, M)
    jax.block_until_ready(dense)
    results = {"n": N, "m": M, "k": K, "nnz": nnz,
               "data_s": time.perf_counter() - t0,
               "iters_per_dispatch": CHUNK,
               "device_kind": jax.devices()[0].device_kind}
    data = dense_only_data(dense)
    for tag in tags:
        prec, bias = CONFIGS[tag]
        cfg = ModelConfig(n=N, m=M, k=K, variant="hpf", sweep="dense",
                          bias=bias, matmul_precision=prec)
        multi = make_multi_step(cfg)
        state = init_state(cfg, seed=1)
        t0 = time.perf_counter()
        state = jax.block_until_ready(multi(state, data, CHUNK))
        results[f"compile_s_{tag}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(dispatches):
            state = multi(state, data, CHUNK)
        jax.block_until_ready(state)
        ms = (time.perf_counter() - t0) / (dispatches * CHUNK) * 1e3
        results[f"ms_per_iter_{tag}"] = ms
        print(f"{tag}: {ms:.3f} ms/iter ({CHUNK} iters/dispatch)",
              file=sys.stderr, flush=True)
        if not np.isfinite(np.asarray(state.theta.e)).all():
            raise FloatingPointError(f"non-finite state ({tag})")
    return results


def main():
    from hgaprec_jax.compile_cache import configure_compile_cache
    configure_compile_cache()
    tags = sys.argv[1].split(",") if len(sys.argv) > 1 else tuple(CONFIGS)
    results = netflix_timings(tags)
    out = os.path.join(ROOT, ".bench_cache", "netflix_scale.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
        fh.write("\n")
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
