"""The compiled fused dense kernel on a GPU (marker `gpu`).

These run only where JAX has a GPU: `HGAPREC_TEST_GPU=1 python -m pytest
-m gpu tests/test_dense_gpu.py`, or phase e of `python chip_smoke.py`.
Elsewhere the `gpu` fixture skips them; tests/test_dense_pallas.py runs
the same kernel through the Pallas interpreter on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hgaprec_jax.ops.dense_pallas import fused_dense_sweep
from hgaprec_jax.ops.sweep import Kernels, select_kernels

pytestmark = pytest.mark.gpu


def _reference(y, a, b, ba=None, bb=None):
    """f64 NumPy (W B, W^T A[, rowsum W, colsum W])."""
    s = a @ b.T
    if ba is not None:
        s = s + ba[:, None] + bb[None, :]
    w = np.where(y > 0, y / s, 0.0)
    out = [w @ b, w.T @ a]
    if ba is not None:
        out += [w.sum(1), w.sum(0)]
    return out


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("bias", [False, True])
def test_compiled_kernel_vs_f64(gpu, bias, bf16):
    """Odd N, M off the tile, K = 100: bf16 operands within the 2e-2
    bound, IEEE f32 operands within summation order."""
    rng = np.random.default_rng(5)
    n, m, k = 999, 777, 100
    y = np.where(rng.random((n, m)) < 0.05, rng.integers(1, 256, (n, m)), 0)
    a = np.exp(0.3 * rng.normal(size=(n, k)) - 1.0)
    b = np.exp(0.3 * rng.normal(size=(m, k)) - 1.0)
    ba = np.exp(0.3 * rng.normal(size=n) - 2.0)
    bb = np.exp(0.3 * rng.normal(size=m) - 2.0)
    ref = _reference(y, a, b, *((ba, bb) if bias else ()))
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    got = fused_dense_sweep(f32(a), f32(b), jnp.asarray(y, jnp.uint8),
                            *((f32(ba), f32(bb)) if bias else ()),
                            bf16=bf16)
    tol = 2e-2 if bf16 else 1e-4
    for g, r in zip(got, ref):
        assert _rel(g, r) <= tol


def test_u8_block_past_2gib(gpu):
    """A u8 count block between 2 and 4 GiB (the hybrid head of a
    million-user catalog): rows past 2^31 bytes must read their own
    counts, which 32-bit u8 element offsets would not."""
    rng = np.random.default_rng(7)
    rows, cols, k = 524800, 4096, 100          # 2.15e9 bytes
    hot = np.concatenate([np.arange(64), rows - 64 + np.arange(64)])
    y_hot = np.where(rng.random((hot.size, cols)) < 0.05,
                     rng.integers(1, 5, (hot.size, cols)), 0)
    y = jnp.zeros((rows, cols), jnp.uint8).at[hot].set(
        jnp.asarray(y_hot, jnp.uint8))
    a = np.exp(0.3 * rng.normal(size=(rows, k)) - 1.0)
    b = np.exp(0.3 * rng.normal(size=(cols, k)) - 1.0)
    acc_a, acc_b = fused_dense_sweep(jnp.asarray(a, jnp.float32),
                                     jnp.asarray(b, jnp.float32), y,
                                     bf16=True)
    ref_a, ref_b = _reference(y_hot, a[hot], b)
    assert _rel(np.asarray(acc_a)[hot], ref_a) <= 2e-2
    assert _rel(acc_b, ref_b) <= 2e-2
    del y


def test_selector_picks_fused_kernel(gpu):
    got = select_kernels(jax.default_backend(), "dense", k=100, bias=True,
                         precision="default")
    assert got.block == "fused"


def test_step_fused_vs_xla(gpu, monkeypatch):
    """One HPF CAVI step at precision "default" through the fused kernel
    against the same step through the XLA dense sums."""
    import hgaprec_jax.ops.sweep as sw
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.synthetic import dense_counts_on_device
    from hgaprec_jax.models.state import init_state
    from hgaprec_jax.models.step import cavi_step
    from hgaprec_jax.data.device import dense_only_data

    n, m = 3000, 1000
    dense, nnz = dense_counts_on_device(n, m, scale=2.0, chunk=512,
                                        col_multiple=128)
    assert nnz > 0
    data = dense_only_data(dense)
    cfg = ModelConfig(n=n, m=m, k=100, variant="hpf", sweep="dense",
                      bias=True, matmul_precision="default")
    # a fresh function per run, so the second trace sees the patch
    fused = jax.jit(lambda s, d: cavi_step(s, d, cfg))(
        init_state(cfg, seed=3), data)
    monkeypatch.setattr(sw, "select_kernels",
                        lambda *a, **kw: Kernels("xla", None))
    xla = jax.jit(lambda s, d: cavi_step(s, d, cfg))(
        init_state(cfg, seed=3), data)
    for g, r in ((fused.theta.e, xla.theta.e), (fused.beta.e, xla.beta.e)):
        assert _rel(g, np.asarray(r, np.float64)) <= 2e-2
