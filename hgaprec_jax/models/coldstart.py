"""Cold-start fold-in: infer a fresh user's factors from seed items.

Generalizes the reference's hand-run `test()` demo (hgaprec.cc:2257-2346):
reset one user's theta row to its prior, then run a few CAVI iterations
over only the seed items while beta stays frozen, and rank all items.
Device-side and batched: any number of fresh users at once.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hgaprec_jax.config import ModelConfig
from hgaprec_jax.models.state import ModelState
from hgaprec_jax.ops.gamma import expectations


@functools.partial(jax.jit, static_argnums=(3, 4))
def _fold_in(beta_e, beta_elog, seed_items, k: int, iters: int, a, b):
    """seed_items: i32[U, S] item ids per fresh user (pad with -1)."""
    betarowsum = jnp.sum(beta_e, axis=0)                       # [K]
    valid = (seed_items >= 0)
    items = jnp.maximum(seed_items, 0)

    # theta starts at the prior expectation like set_to_prior_curr +
    # compute_expectations (hgaprec.cc:2277-2278)
    u = seed_items.shape[0]
    shape0 = jnp.full((u, k), a)
    rate0 = jnp.full((k,), b)
    _, elog0 = expectations(shape0, rate0)

    def body(_, elog_t):
        # phi per (user, seed item): softmax over k of Elog theta + Elog beta
        logits = elog_t[:, None, :] + beta_elog[items]         # [U, S, K]
        phi = jax.nn.softmax(logits, axis=-1)
        phi = jnp.where(valid[:, :, None], phi, 0.0)
        shape = a + jnp.sum(phi, axis=1)                       # [U, K]
        rate = b + betarowsum                                  # [K]
        _, elog = expectations(shape, rate)
        return elog

    elog_t = jax.lax.fori_loop(0, iters, body, elog0)
    # final expectations for scoring
    logits = elog_t[:, None, :] + beta_elog[items]
    phi = jnp.where(valid[:, :, None], jax.nn.softmax(logits, -1), 0.0)
    shape = a + jnp.sum(phi, axis=1)
    rate = b + betarowsum
    e, _ = expectations(shape, rate)
    scores = jnp.dot(e, beta_e.T, preferred_element_type=jnp.float32)
    return e, scores


def fold_in_users(state: ModelState, cfg: ModelConfig,
                  seed_items: Sequence[Sequence[int]], iters: int = 10
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (theta_e [U, K], scores [U, M]) for fresh users described
    by their seed item lists."""
    smax = max(len(s) for s in seed_items)
    mat = np.full((len(seed_items), smax), -1, np.int32)
    for r, s in enumerate(seed_items):
        mat[r, :len(s)] = s
    e, scores = _fold_in(state.beta.e, state.beta.elog, jnp.asarray(mat),
                         cfg.k, iters, cfg.a, cfg.b)
    return np.asarray(e), np.asarray(scores)


def top_items(scores: np.ndarray, exclude: Sequence[Sequence[int]],
              topn: int = 20) -> list:
    """Top-N ranked item ids per fresh user, excluding seed items."""
    out = []
    for r in range(scores.shape[0]):
        s = scores[r].copy()
        s[np.asarray(list(exclude[r]), dtype=np.int64)] = -np.inf
        out.append(np.argsort(-s, kind="stable")[:topn].tolist())
    return out
