"""data/synthetic.py::zipf_coo, the big-sparse presets' stream."""

import numpy as np
import pytest
from scipy.special import zeta

from hgaprec_jax.data.synthetic import zipf_coo


def test_stream_is_user_sorted_and_deduplicated():
    n, m = 3000, 500
    u, i, y = zipf_coo(n, m, 40000)
    assert u.dtype == i.dtype == np.int32 and y.dtype == np.float32
    key = u.astype(np.int64) * m + i
    assert np.all(np.diff(key) > 0)            # (u, i)-sorted, no repeats
    assert 0 <= u.min() and u.max() < n and 0 <= i.min() and i.max() < m
    assert set(np.unique(y)) <= {1.0, 2.0, 3.0, 4.0}
    # deduplication removed the repeated popular pairs
    assert u.size < 40000


@pytest.mark.parametrize("item", ["first", "last"])
def test_item_marginal_is_clipped_zipf(item):
    """Few draws per user, so deduplication barely acts: item 0 takes
    P(X = 1) = 1 / zeta(1.2) of the draws and the last item the whole
    tail P(X >= m), as np.minimum(rng.zipf(1.2) - 1, m - 1) gives."""
    n, m, draws = 1_000_000, 1000, 50000
    _, i, _ = zipf_coo(n, m, draws, seed=11)
    ks = np.arange(1, m, dtype=np.float64)
    p = {"first": 1.0 / zeta(1.2),
         "last": 1.0 - np.sum(ks ** -1.2) / zeta(1.2)}[item]
    got = np.mean(i == (0 if item == "first" else m - 1))
    assert abs(got - p) < 4 * np.sqrt(p * (1 - p) / i.size) + 0.01 * p


def test_seed_fixes_the_stream():
    a = zipf_coo(500, 300, 5000, seed=3)
    b = zipf_coo(500, 300, 5000, seed=3)
    c = zipf_coo(500, 300, 5000, seed=4)
    assert all(np.array_equal(x, z) for x, z in zip(a, b))
    assert not np.array_equal(a[1], c[1])
