"""Test harness: force an 8-device CPU mesh before JAX initializes.

HGAPREC_TEST_GPU=1 keeps the default backend instead, for the tests
marked `gpu` (tests/test_dense_gpu.py), which run the compiled GPU
kernels: `HGAPREC_TEST_GPU=1 python -m pytest -m gpu tests/` on a machine
with a card, or `python chip_smoke.py`, which runs the same checks. The
`gpu` fixture skips them on any other backend.
"""

import os

_USE_GPU = os.environ.get("HGAPREC_TEST_GPU") == "1"

# CPU with 8 virtual devices: the sharded tests need a mesh, and f32 CPU
# matmuls keep the golden comparisons exact
if not _USE_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"   # for any subprocesses
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not _USE_GPU:
    jax.config.update("jax_platforms", "cpu")

from hgaprec_jax.compile_cache import configure_compile_cache

configure_compile_cache()

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "gpu: runs a compiled GPU kernel; skips on other backends")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at run time, never while
    the module is imported, so every xdist worker collects the same
    tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Triton kernel, no interpret mode")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_synthetic(rng, n=40, m=30, k=3, density=0.3, max_count=5,
                   binary=False, rating_threshold=1):
    """Small synthetic ratings store + validation/test maps."""
    from hgaprec_jax.data.ratings import RatingsStore

    store = RatingsStore(n, m, binary=binary,
                         rating_threshold=rating_threshold)
    mask = rng.random((n, m)) < density
    counts = rng.integers(1, max_count + 1, size=(n, m))
    u, i = np.nonzero(mask)
    y = counts[u, i]
    # hold out ~20% test, ~5% validation
    r = rng.random(u.size)
    tr = r < 0.75
    va = (r >= 0.75) & (r < 0.8)
    te = r >= 0.8
    store.add_training(u[tr] + 1, i[tr] + 1, y[tr])  # external ids offset
    store.finalize()
    validation = {}
    test = {}
    for a, b, c in zip(u[va], i[va], y[va]):
        un = store.user2seq.get(a + 1)
        mn = store.movie2seq.get(b + 1)
        if un is not None and mn is not None:
            validation[(un, mn)] = int(c)
    for a, b, c in zip(u[te], i[te], y[te]):
        un = store.user2seq.get(a + 1)
        mn = store.movie2seq.get(b + 1)
        if un is not None and mn is not None:
            test[(un, mn)] = int(c)
    return store, validation, test


@pytest.fixture
def synthetic(rng):
    return make_synthetic(rng)
