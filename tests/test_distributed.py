"""parallel.distributed: single-process bootstrap behavior."""

import jax

from hgaprec_jax.parallel import distributed


def test_single_process_is_noop(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert distributed.initialize_from_env() is False


def test_primary_and_slice_single_process():
    assert distributed.is_primary()
    s = distributed.local_device_slice(100)
    assert (s.start, s.stop) == (0, 100)
    assert jax.process_count() == 1


def test_user_rows_ingest(tmp_path):
    """Per-host ingest slices the training COO but keeps global id maps
    (vectorized ingest path, >10k rows) — data/ratings.py user_rows."""
    import numpy as np

    from hgaprec_jax.data.ratings import load_dataset
    from hgaprec_jax.data.synthetic import write_pf_dataset

    write_pf_dataset(str(tmp_path), np.random.default_rng(4), 400, 200,
                     k=6, scale=6.0)
    full, val_f, test_f = load_dataset(str(tmp_path), 400, 200, False, 1)
    assert full.nratings > 10000   # vectorized path engaged

    n = full.n
    lo, hi = 0, n // 2
    part, val_p, test_p = load_dataset(str(tmp_path), 400, 200, False, 1,
                                       user_rows=slice(lo, hi))
    # global maps, sliced COO
    assert part.n == n and part.m == full.m
    assert part.user2seq == full.user2seq
    assert val_p == val_f and test_p == test_f
    assert part.local_user_rows == slice(lo, hi)
    assert 0 < part.nratings < full.nratings
    assert part.coo_u.min() >= lo and part.coo_u.max() < hi
    # the slice holds exactly the full store's rows for those users
    sel = (full.coo_u >= lo) & (full.coo_u < hi)
    np.testing.assert_array_equal(part.coo_u, full.coo_u[sel])
    np.testing.assert_array_equal(part.coo_i, full.coo_i[sel])
    np.testing.assert_array_equal(part.coo_y, full.coo_y[sel])

    # callable form resolves against the actual n
    seen = {}

    def rows_fn(actual_n):
        seen["n"] = actual_n
        return slice(n // 2, n)

    part2, _, _ = load_dataset(str(tmp_path), 400, 200, False, 1,
                               user_rows=rows_fn)
    assert seen["n"] == n
    assert part2.nratings + part.nratings == full.nratings
