"""analysis.R-equivalent metric curves + readers + splitter tests."""

import os

import numpy as np

from hgaprec_jax.eval import analysis as an
from hgaprec_jax.data import readers


def test_precision_recall_formulas():
    # one user, 4 recs, test items = 3; hits at positions 1 and 3
    ranking = np.asarray([
        [7, 1, 0.9, 1],
        [7, 2, 0.8, 0],
        [7, 3, 0.7, 1],
        [7, 4, 0.6, 0],
    ])
    p, r = an.precision_recall_curves(ranking, {7: 3}, num_recs=(2, 4))
    # hits@2 = 1, hits@4 = 2
    assert p[0] == 1 / min(3, 2) and p[1] == 2 / min(3, 4)
    assert r[0] == 1 / 3 and abs(r[1] - 2 / 3) < 1e-12


def test_roc_auc_perfect_and_random(rng):
    truth = np.asarray([1, 1, 0, 0])
    fpr, tpr, auc = an.roc_curve(truth, np.asarray([0.9, 0.8, 0.2, 0.1]))
    assert auc == 1.0
    _, _, auc2 = an.roc_curve(truth, np.asarray([0.2, 0.9, 0.8, 0.1]))
    assert 0.0 < auc2 < 1.0


def test_movielens_double_colon(tmp_path):
    p = tmp_path / "ratings.dat"
    p.write_text("1::10::5::978300760\n2::20::3::978302109\n")
    u, i, y = readers.read_movielens(str(p))
    assert u.tolist() == [1, 2] and i.tolist() == [10, 20]
    assert y.tolist() == [5, 3]


def test_netflix_reader(tmp_path):
    (tmp_path / "mv_0000001.txt").write_text("1:\n6,4,2005-09-06\n7,5,x\n")
    (tmp_path / "mv_0000002.txt").write_text("2:\n6,3,2005-09-06\n")
    u, m, y = readers.read_netflix_dir(str(tmp_path))
    assert u.tolist() == [6, 7, 6]
    assert m.tolist() == [1, 1, 2]
    assert y.tolist() == [4, 5, 3]


def test_mendeley_reader(tmp_path):
    (tmp_path / "users.dat").write_text("3 5 9 11\n1 2\n")
    u, m, y = readers.read_mendeley(str(tmp_path / "users.dat"))
    assert u.tolist() == [1, 1, 1, 2]
    assert m.tolist() == [5, 9, 11, 2]
    assert (y == 1).all()


def test_triplets_reader(tmp_path):
    p = tmp_path / "train_triplets.txt"
    p.write_text("ua\tsong1\t3\nub\tsong1\t1\nua\tsong2\t2\n")
    u, m, y, str2id = readers.read_triplets(str(p))
    assert u.tolist() == [1, 3, 1]  # shared id namespace, first-seen
    assert m.tolist() == [2, 2, 4]
    assert y.tolist() == [3, 1, 2]


def test_create_train_test_sets(tmp_path, rng):
    u = rng.integers(1, 50, 2000)
    i = rng.integers(1, 40, 2000)
    y = rng.integers(1, 6, 2000)
    counts = readers.create_train_test_sets(u, i, y, str(tmp_path),
                                            heldout_ratio=0.2,
                                            validation_ratio=0.05, seed=1)
    total = counts["train"] + counts["validation"] + counts["test"]
    assert total == 2000
    assert 300 < counts["test"] < 500
    assert os.path.exists(tmp_path / "test_users.tsv")
    # loadable by the training path
    from hgaprec_jax.data.ratings import load_dataset
    store, val, test = load_dataset(str(tmp_path), 50, 40, False, 1)
    assert store.nratings == counts["train"]


def test_leave_one_out_split(tmp_path, rng):
    u = np.repeat(np.arange(1, 21), 10)
    i = np.tile(np.arange(1, 11), 20)
    y = np.ones(200, np.int64)
    counts = readers.create_train_test_sets(u, i, y, str(tmp_path),
                                            leave_one_out=True, seed=2)
    assert counts["test"] == 20  # exactly one per user
    assert counts["test_users"] == 20


def test_vectorized_ingest_matches_scalar(tmp_path, rng):
    """Shuffled external ids: vectorized remap == per-row reference path."""
    from hgaprec_jax.data.ratings import RatingsStore
    u = rng.integers(100, 900, 15000)
    i = rng.integers(5000, 5400, 15000)
    y = rng.integers(0, 6, 15000)  # include zeros (dropped)
    path = tmp_path / "train.tsv"
    with open(path, "w") as f:
        f.write("".join(f"{a}\t{b}\t{c}\n" for a, b, c in zip(u, i, y)))

    fast = RatingsStore(10**6, 10**6)
    fast.read_generic(str(path), None)   # vectorized (>10k rows)
    fast.finalize()

    slow = RatingsStore(10**6, 10**6)
    slow.add_training(u, i, y)           # scalar path
    slow.finalize()

    assert fast.user2seq == slow.user2seq
    assert fast.movie2seq == slow.movie2seq
    np.testing.assert_array_equal(fast.coo_u, slow.coo_u)
    np.testing.assert_array_equal(fast.coo_i, slow.coo_i)
    np.testing.assert_array_equal(fast.coo_y, slow.coo_y)


def test_vectorized_ingest_capacity_cap(tmp_path, rng):
    from hgaprec_jax.data.ratings import RatingsStore
    u = rng.integers(0, 50, 20000)
    i = rng.integers(0, 50, 20000)
    y = rng.integers(1, 5, 20000)
    path = tmp_path / "train.tsv"
    with open(path, "w") as f:
        f.write("".join(f"{a}\t{b}\t{c}\n" for a, b, c in zip(u, i, y)))
    fast = RatingsStore(10, 7)
    fast.read_generic(str(path), None)
    fast.finalize()
    slow = RatingsStore(10, 7)
    slow.add_training(u, i, y)
    slow.finalize()
    assert fast.n == 10 and fast.m == 7
    assert fast.user2seq == slow.user2seq
    np.testing.assert_array_equal(fast.coo_u, slow.coo_u)
    np.testing.assert_array_equal(fast.coo_y, slow.coo_y)


def test_device_topk_matches_host(rng):
    """Streamed device top-k == host argsort path on the same scorer."""
    import jax.numpy as jnp
    from conftest import make_synthetic
    from hgaprec_jax.eval.ranking import EvalIndex, masked_user_scores
    from hgaprec_jax.eval.score import Scorer
    from hgaprec_jax.eval.topk import masked_topk
    store, validation, test = make_synthetic(rng, n=40, m=60, density=0.2)
    k = 4
    sc = Scorer(jnp.asarray(rng.random((store.n, k)), jnp.float32),
                jnp.asarray(rng.random((store.m, k)), jnp.float32),
                None, None, 0.0)
    index = EvalIndex(validation, test)
    users = np.arange(0, store.n, 3, dtype=np.int32)
    host = masked_user_scores(sc, store, index, users)
    vals, ids = masked_topk(sc, store, index, users, k=10, item_chunk=16)
    for r in range(users.size):
        expect = np.sort(host[r])[::-1][:10]
        np.testing.assert_allclose(vals[r], expect, rtol=1e-5, atol=1e-6)
