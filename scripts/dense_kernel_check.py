#!/usr/bin/env python
"""Fused dense GPU kernel against the XLA dense sums, at the preset shapes.

For each shape the script builds a u8 count block on the device, draws
random positive factors from a seed, checks the fused kernel
(ops/dense_pallas.py) against the XLA form (ops/sweep.py::dense_sums)
and times both, with and without biases, at matmul precision "default"
(bf16 operands in the kernel); at "highest" (f32 operands) it times the
XLA form alone, which the sweep runs at that precision. Netflix also
checks the kernel at both precisions against an f64 NumPy reference on
a 16384-user slice.

  netflix   480189 x 17770, HPF generator (data/synthetic.py)
  ml1m      6040 x 3681, HPF generator, built through build_device_data
  echonest  the hybrid head block: 1019318 x 4096 at 0.87% density
            (the EchoNest preset's top-4096 items hold about 36M of its
            45M nonzeros); uniform cells, since the dense kernels' cost
            does not depend on where the nonzeros fall

Usage: python scripts/dense_kernel_check.py [shape ... | tiles]
`tiles` times the kernel's tile and warp choices at the Netflix shape.
Prints one JSON line per measurement (an error too); needs a GPU.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hgaprec_jax.compile_cache import configure_compile_cache  # noqa: E402

K = 100
REPS = 5


def emit(**rec):
    print(json.dumps(rec), flush=True)


def factors(n, m, seed, bias):
    ka, kb, kc, kd = jax.random.split(jax.random.PRNGKey(seed), 4)
    a = jnp.exp(0.3 * jax.random.normal(ka, (n, K)) - 1.0)
    b = jnp.exp(0.3 * jax.random.normal(kb, (m, K)) - 1.0)
    if not bias:
        return a, b, None, None
    return (a, b, jnp.exp(0.3 * jax.random.normal(kc, (n,)) - 2.0),
            jnp.exp(0.3 * jax.random.normal(kd, (m,)) - 2.0))


def block(shape):
    from hgaprec_jax.data.synthetic import dense_counts_on_device
    if shape == "netflix":
        y, _ = dense_counts_on_device(480189, 17770)
        return y, 480189, 17770
    if shape == "ml1m":
        from hgaprec_jax.data.device import build_device_data
        from hgaprec_jax.data.ratings import RatingsStore
        from hgaprec_jax.data.synthetic import generate_pf_counts
        u, i, c = generate_pf_counts(np.random.default_rng(20260817), 6040,
                                     3681, k=8, a=0.3, ap=1.8, b=0.3,
                                     scale=0.7)
        store = RatingsStore(6040, 3681)
        store._u, store._i, store._y = u, i, c
        store.user2seq = dict.fromkeys(range(6040), 0)
        store.movie2seq = dict.fromkeys(range(3681), 0)
        store.finalize()
        return build_device_data(store).dense_y, 6040, 3681
    n, t = 1019318, 4096
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))

    @jax.jit
    def gen():
        rows = -(-n // 512) * 512
        hit = jax.random.uniform(k1, (rows, t)) < 0.0087
        hit = hit & (jnp.arange(rows)[:, None] < n)
        return jnp.where(hit, jax.random.randint(k2, (rows, t), 1, 5),
                         0).astype(jnp.uint8)
    return gen(), n, t


def timed(fn, *args):
    out = jax.block_until_ready(fn(*args))          # compile + warm
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / REPS * 1e3


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)))


def tile_sweep(y, n, m):
    from hgaprec_jax.ops.dense_pallas import fused_dense_sweep
    a, b, _, _ = factors(n, m, 3, False)
    base = None
    for prec in ("default",):
        for tu, tc, warps, stages in ((64, 64, 4, 3), (128, 64, 8, 3),
                                      (64, 128, 4, 3), (64, 128, 8, 3),
                                      (64, 64, 4, 4), (64, 32, 4, 3)):
            fn = jax.jit(lambda a, b, y, prec=prec, tu=tu, tc=tc,
                         warps=warps, stages=stages: fused_dense_sweep(
                             a, b, y, bf16=prec == "default", tile_u=tu,
                             tile_c=tc, num_warps=warps, num_stages=stages))
            try:
                got, ms = timed(fn, a, b, y)
            except Exception as e:  # a variant the compiler refuses
                emit(tiles=[tu, tc, warps, stages], precision=prec,
                     error=str(e)[:300])
                continue
            if base is None:
                base = got
            emit(tiles=[tu, tc, warps, stages], precision=prec, fused_ms=ms,
                 vs_first=max(rel(g, r) for g, r in zip(got, base)))


def reference(a, b, ba, bb, y):
    """f64 NumPy W B, W^T A, rowsum W, colsum W."""
    a, b, y = (np.asarray(x, np.float64) for x in (a, b, y))
    s = a @ b.T
    if ba is not None:
        s += np.asarray(ba, np.float64)[:, None] + \
            np.asarray(bb, np.float64)[None, :]
    w = np.where(y > 0, y / s, 0.0)
    out = [w @ b, w.T @ a]
    if ba is not None:
        out += [w.sum(1), w.sum(0)]
    return out


def main():
    from hgaprec_jax.ops.dense_pallas import fused_dense_sweep
    from hgaprec_jax.ops.sweep import dense_sums

    if jax.default_backend() != "gpu":
        sys.exit("needs a GPU")
    emit(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), device_kind=jax.devices()[0].device_kind)
    shapes = sys.argv[1:] or ["netflix", "ml1m", "echonest"]
    for shape in shapes:
        t0 = time.perf_counter()
        y, n, m = block("netflix" if shape == "tiles" else shape)
        jax.block_until_ready(y)
        emit(shape=shape, y_shape=list(y.shape),
             build_s=time.perf_counter() - t0)
        if shape == "tiles":
            tile_sweep(y, n, m)
            continue
        for bias in (False, True):
            a, b, ba, bb = factors(n, m, 3, bias)
            if shape == "netflix":
                rows = min(16384, n)
                ref = reference(a[:rows], b, None if ba is None else
                                ba[:rows], bb, y[:rows, :m])
            for prec in ("highest", "default"):
                fused = jax.jit(lambda a, b, ba, bb, y, prec=prec:
                                fused_dense_sweep(a, b, y, ba, bb,
                                                  bf16=prec == "default"))
                xla = jax.jit(lambda a, b, ba, bb, y, prec=prec:
                              dense_sums(a, b, ba, bb, y, item_block=4096,
                                         user_block=8192, precision=prec))
                try:
                    got_x, ms_x = timed(xla, a, b, ba, bb, y)
                    rec = dict(shape=shape, bias=bias, precision=prec,
                               xla_ms=ms_x)
                    if prec == "default":
                        got_f, ms_f = timed(fused, a, b, ba, bb, y)
                        rec.update(fused_ms=ms_f, fused_vs_xla=max(
                            rel(g, r) for g, r in zip(got_f, got_x)))
                except Exception as e:
                    emit(shape=shape, bias=bias, precision=prec,
                         error=str(e)[:2000])
                    continue
                if shape == "netflix":
                    sl = jax.jit(lambda a, b, ba, bb, y, prec=prec:
                                 fused_dense_sweep(
                                     a[:rows], b, y[:rows], None if ba is None
                                     else ba[:rows], bb,
                                     bf16=prec == "default"))
                    rec["fused_vs_f64"] = max(
                        rel(g, r) for g, r in
                        zip(sl(a, b, ba, bb, y), ref))
                emit(**rec)
        del y


if __name__ == "__main__":
    configure_compile_cache()
    main()
