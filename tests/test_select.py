"""ops/sweep.py::select_kernels — the one place that picks a sweep's
kernels from the backend and the shapes — and the dispatch it drives."""

import numpy as np
import jax.numpy as jnp
import pytest

from hgaprec_jax.ops.sweep import Kernels, select_kernels


@pytest.mark.parametrize("backend,mode,k,bias,precision,compact,expect", [
    # the fused Triton kernel: GPU, bf16 operands, rows that fit MAX_KP
    ("gpu", "dense", 100, False, "default", False, ("fused", None)),
    ("gpu", "dense", 100, True, "default", False, ("fused", None)),
    ("gpu", "hybrid", 100, True, "default", True, ("fused", "mxu")),
    ("gpu", "dense", 126, True, "default", False, ("fused", None)),
    # f32 operands: XLA's matmuls win on the GPU
    ("gpu", "dense", 100, False, "highest", False, ("xla", None)),
    ("gpu", "hybrid", 100, False, "highest", True, ("xla", "mxu")),
    # rows wider than MAX_KP after the two bias columns
    ("gpu", "dense", 127, True, "default", False, ("xla", None)),
    ("gpu", "dense", 200, False, "default", False, ("xla", None)),
    # no compiled kernel off the GPU, at any precision
    ("cpu", "dense", 100, False, "default", False, ("xla", None)),
    ("cpu", "hybrid", 100, True, "highest", True, ("xla", "mxu")),
    ("cpu", "dense", 100, True, "default", False, ("xla", None)),
    # hybrid without a compact stream takes the one-pass COO tail
    ("gpu", "hybrid", 100, False, "default", False, ("fused", "onepass")),
    ("cpu", "segment", 100, False, "highest", False, ("xla", None)),
])
def test_select_kernels_table(backend, mode, k, bias, precision, compact,
                              expect):
    got = select_kernels(backend, mode, k=k, bias=bias,
                         precision=precision, compact_tail=compact)
    assert got == Kernels(*expect)


def _hybrid_data(rng, n=60, m=45):
    from hgaprec_jax.data.device import build_device_data
    from hgaprec_jax.data.ratings import RatingsStore
    nnz = 600
    u = np.sort(rng.integers(0, n, nnz)).astype(np.int64)
    i = rng.integers(0, m, nnz).astype(np.int64)
    y = rng.integers(1, 4, nnz).astype(np.float64)
    store = RatingsStore(n, m)
    store.add_training(u + 1, i + 1, y)
    store.finalize()
    return build_device_data(store, pad_multiple=64, dense=False,
                             hybrid_head_items=8), store


@pytest.mark.parametrize("compact,expect", [
    (True, "mxu"),        # build_device_data builds the compact stream
    (False, "onepass"),   # a layout without it (e.g. hand-built)
    (None, "fused"),      # the head block through the selected dense kernel
])
def test_sweep_hybrid_tail_dispatch(monkeypatch, compact, expect):
    """sweep() runs exactly the kernels select_kernels names: spy on each
    implementation and check which one the hybrid step called."""
    import dataclasses
    import functools

    import hgaprec_jax.ops.sweep as sw

    rng = np.random.default_rng(23)
    data, store = _hybrid_data(rng)
    assert data.tail_compact is not None
    if compact is False:
        data = dataclasses.replace(data, tail_compact=None)
    k = 6
    elog_a = jnp.asarray(np.log(rng.random((store.n, k)) + 0.2))
    elog_b = jnp.asarray(np.log(rng.random((store.m, k)) + 0.2))

    called = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            called.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(sw, "mxu_tail_sweep", spy("mxu", sw.mxu_tail_sweep))
    monkeypatch.setattr(sw, "_segment_onepass_lin",
                        spy("onepass", sw._segment_onepass_lin))
    monkeypatch.setattr(sw, "dense_sums", spy("xla", sw.dense_sums))
    fused = functools.partial(sw.fused_dense_sweep, tile_u=8, tile_c=16,
                              interpret=True)
    monkeypatch.setattr(sw, "fused_dense_sweep", spy("fused", fused))
    if compact is None:
        monkeypatch.setattr(
            sw, "select_kernels",
            lambda *a, **kw: Kernels("fused", "mxu"))
    res = sw.sweep(elog_a, elog_b, None, None, data, "hybrid",
                   precision="default")
    assert expect in called
    assert len(called) == 2          # one head kernel, one tail kernel
    assert np.isfinite(np.asarray(res.acc_a)).all()
