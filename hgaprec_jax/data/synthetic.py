"""Synthetic data from the HPF generative model (arXiv:1311.1704 §2).

Used by tests and by bench.py (the image ships no datasets; the reference's
example tarball is a stripped blob). Draws xi/eta activity/popularity
scales, Gamma factor matrices, and Poisson counts, yielding realistic
long-tailed user/item degree distributions at any (n, m) scale.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def generate_pf_counts(rng: np.random.Generator, n: int, m: int, k: int = 5,
                       a: float = 0.3, ap: float = 1.5, b: float = 0.3,
                       scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """Sample sparse counts (u, i, y) from the hierarchical model."""
    xi = rng.gamma(ap, 1.0 / b, size=n)          # user activity
    eta = rng.gamma(ap, 1.0 / b, size=m)         # item popularity
    theta = rng.gamma(a, 1.0 / xi[:, None], size=(n, k))
    beta = rng.gamma(a, 1.0 / eta[:, None], size=(m, k))
    rate = scale * theta @ beta.T
    y = rng.poisson(rate)
    u, i = np.nonzero(y)
    return u.astype(np.int64), i.astype(np.int64), y[u, i].astype(np.int64)


def write_pf_dataset(outdir: str, rng: np.random.Generator, n: int, m: int,
                     k: int = 5, scale: float = 1.0,
                     test_frac: float = 0.2, valid_frac: float = 0.01,
                     clip: int = 255, **kw) -> int:
    """Write train/validation/test/test_users TSVs; returns nnz.

    Counts are clipped at 255 by default: the reference stores ratings in
    uint8 (yval_t, env.hh:20) and silently wraps larger values mod 256, so
    emitting counts a uint8 can hold keeps both stacks reading identical
    data (real rating datasets never exceed this anyway)."""
    import os
    os.makedirs(outdir, exist_ok=True)
    u, i, y = generate_pf_counts(rng, n, m, k=k, scale=scale, **kw)
    if clip:
        y = np.minimum(y, clip)
    r = rng.random(u.size)
    splits = {
        "train.tsv": r >= test_frac + valid_frac,
        "test.tsv": r < test_frac,
        "validation.tsv": (r >= test_frac) & (r < test_frac + valid_frac),
    }
    for fname, sel in splits.items():
        with open(os.path.join(outdir, fname), "w") as f:
            f.write("".join(f"{a + 1}\t{b + 1}\t{c}\n" for a, b, c in
                            zip(u[sel], i[sel], y[sel])))
    test_users = np.unique(u[r < test_frac])
    with open(os.path.join(outdir, "test_users.tsv"), "w") as f:
        f.write("".join(f"{a + 1}\n" for a in test_users))
    return int(u.size)


def generate_pf_counts_chunked(rng: np.ndarray, n: int, m: int, k: int = 8,
                               a: float = 0.3, ap: float = 1.5,
                               b: float = 0.3, scale: float = 1.0,
                               user_chunk: int = 20000):
    """Chunked sampler for large shapes (Netflix: 480k x 17.7k) — the
    dense [n, m] rate matrix never materializes; yields COO arrays."""
    eta = rng.gamma(ap, 1.0 / b, size=m)
    beta = rng.gamma(a, 1.0 / eta[:, None], size=(m, k)).astype(np.float32)
    us, is_, ys = [], [], []
    for lo in range(0, n, user_chunk):
        hi = min(lo + user_chunk, n)
        xi = rng.gamma(ap, 1.0 / b, size=hi - lo)
        theta = rng.gamma(a, 1.0 / xi[:, None],
                          size=(hi - lo, k)).astype(np.float32)
        rate = scale * theta @ beta.T
        y = rng.poisson(rate.astype(np.float64))
        uu, ii = np.nonzero(y)
        us.append((uu + lo).astype(np.int64))
        is_.append(ii.astype(np.int64))
        ys.append(y[uu, ii].astype(np.int64))
    return (np.concatenate(us), np.concatenate(is_), np.concatenate(ys))


def dense_counts_on_device(n: int, m: int, *, seed: int = 7,
                           scale: float = 0.12, k: int = 8,
                           chunk: int = 4096, col_multiple: int = 4096):
    """u8[N_pad, M_pad] counts from the HPF generative model, sampled on
    the device (Netflix preset: about 9.8 GB, too large to stage on the
    host and copy over). Returns (dense, nnz).

    Bernoulli-Poisson sparsity with truncated-Poisson counts, one jitted
    lax.scan over user chunks. Rows are padded to a multiple of `chunk`
    and columns to `col_multiple` so the sweeps tile the matrix in place;
    padding cells hold zero counts."""
    import jax
    import jax.numpy as jnp

    n_pad = -(-n // chunk) * chunk
    m_pad = -(-m // col_multiple) * col_multiple
    kb, ke, kloop = jax.random.split(jax.random.PRNGKey(seed), 3)

    @jax.jit
    def gen(kb, ke, kloop):
        eta = jax.random.gamma(ke, 1.8, (m,)) / 0.3
        beta = jax.random.gamma(kb, 0.3, (m, k)) / eta[:, None]
        # padding columns get zero rate -> zero counts
        beta = jnp.pad(beta, ((0, m_pad - m), (0, 0)))

        def body(carry, c):
            dense, nnz, key = carry
            key, kx, kt, ku, kp = jax.random.split(key, 5)
            xi = jax.random.gamma(kx, 1.8, (chunk,)) / 0.3
            theta = jax.random.gamma(kt, 0.3, (chunk, k)) / xi[:, None]
            rate = scale * jnp.dot(theta, beta.T,
                                   precision=jax.lax.Precision.HIGHEST)
            mask = jax.random.uniform(ku, rate.shape) < -jnp.expm1(-rate)
            y = jnp.where(mask, 1 + jax.random.poisson(kp, rate), 0)
            rows = c * chunk + jnp.arange(chunk)[:, None]
            blk = jnp.minimum(jnp.where(rows < n, y, 0), 255
                              ).astype(jnp.uint8)
            dense = jax.lax.dynamic_update_slice(dense, blk, (c * chunk, 0))
            return (dense, nnz + jnp.sum(blk > 0, dtype=jnp.int32), key), None

        init = (jnp.zeros((n_pad, m_pad), jnp.uint8),
                jnp.zeros((), jnp.int32), kloop)
        (dense, nnz, _), _ = jax.lax.scan(
            body, init, jnp.arange(n_pad // chunk, dtype=jnp.int32))
        return dense, nnz

    dense, nnz = gen(kb, ke, kloop)
    return dense, int(nnz)


def zipf_coo(n: int, m: int, draws: int, *, seed: int = 5):
    """Power-law COO stream, user-sorted and deduplicated.

    Item popularity is zipf(1.2) — the marginal family the reference's
    own analysis fits to plays/clicks (marg.R NB fits; EchoNest/NYT are
    heavily head-concentrated) — with the mass past the catalog on its
    last item; user activity is power(3), u = n U^(1/3). Deduplication
    removes a share of the draws that grows with the skew: 85M draws at
    the EchoNest preset leave about 45M nonzeros.

    Sampled and sorted on the device (inverse CDF of the zipf law, one
    two-key sort), deduplicated on the host: at preset scale this takes
    seconds where host sampling took minutes. Returns host arrays
    (u i32, i i32, y f32 in 1..4)."""
    import jax
    import jax.numpy as jnp
    from scipy.special import zeta

    # survival function of zipf(1.2) at 1..m-1, decreasing from 1: an
    # item draw is the number of its values >= V, V uniform on (0, 1]
    ks = np.arange(1, m, dtype=np.float64)
    surv = 1.0 - np.cumsum(ks ** -1.2) / zeta(1.2)

    @jax.jit
    def sample(key, neg_surv):
        ku, ki, ky = jax.random.split(key, 3)
        u = jnp.minimum(
            (n * jax.random.uniform(ku, (draws,)) ** (1 / 3)).astype(
                jnp.int32), n - 1)
        v = 1.0 - jax.random.uniform(ki, (draws,))
        i = jnp.searchsorted(neg_surv, -v, side="right").astype(jnp.int32)
        u, i = jax.lax.sort((u, i), num_keys=2)
        keep = jnp.concatenate([jnp.ones(1, bool),
                                (u[1:] != u[:-1]) | (i[1:] != i[:-1])])
        y = jax.random.randint(ky, (draws,), 1, 5).astype(jnp.float32)
        return u, i, y, keep

    u, i, y, keep = jax.device_get(sample(
        jax.random.PRNGKey(seed), jnp.asarray(-surv, jnp.float32)))
    return u[keep], i[keep], y[keep]
