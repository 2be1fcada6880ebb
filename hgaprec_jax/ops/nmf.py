"""Native NMF in XLA — replaces the reference's bundled libNMF.

The reference optionally links University-of-Vienna libNMF and calls
nmfDriver(..., mu, ...) — multiplicative-update NMF — on a dense dump of
the training matrix (hgaprec.cc:891-917, src/nmflib/). Here the same
capability is a ~40-line jitted Lee–Seung loop: dense matmuls that map
straight onto the device's matmul units, no BLAS/LAPACK/ARPACK
dependency.

W: [N, K] user factors, H: [K, M] item factors, V ≈ W H (Frobenius).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-9


@functools.partial(jax.jit, static_argnums=(1, 2))
def _nmf_mu(v: jax.Array, k: int, iters: int, key: jax.Array
            ) -> Tuple[jax.Array, jax.Array]:
    n, m = v.shape
    kw, kh = jax.random.split(key)
    w = jax.random.uniform(kw, (n, k), v.dtype, 1e-3, 1.0)
    h = jax.random.uniform(kh, (k, m), v.dtype, 1e-3, 1.0)

    def body(_, wh):
        w, h = wh
        # H <- H * (W^T V) / (W^T W H)
        wt_v = jnp.dot(w.T, v, preferred_element_type=jnp.float32)
        wt_wh = jnp.dot(jnp.dot(w.T, w,
                                preferred_element_type=jnp.float32), h,
                        preferred_element_type=jnp.float32)
        h = h * wt_v / (wt_wh + _EPS)
        # W <- W * (V H^T) / (W H H^T)
        v_ht = jnp.dot(v, h.T, preferred_element_type=jnp.float32)
        w_hht = jnp.dot(w, jnp.dot(h, h.T,
                                   preferred_element_type=jnp.float32),
                        preferred_element_type=jnp.float32)
        w = w * v_ht / (w_hht + _EPS)
        return (w, h)

    w, h = jax.lax.fori_loop(0, iters, body, (w, h))
    return w, h


def nmf(dense_counts, k: int, iters: int = 100, seed: int = 0
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Factorize the (dense) count matrix; returns (theta [N,K],
    beta [M,K]) for the Scorer (prediction_score_nmf, hgaprec.cc:1877-1886
    scores theta[n]·beta[m])."""
    v = jnp.asarray(dense_counts, jnp.float32)
    w, h = _nmf_mu(v, k, iters, jax.random.PRNGKey(seed))
    return np.asarray(w), np.asarray(h).T.copy()
