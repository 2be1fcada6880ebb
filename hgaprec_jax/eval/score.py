"""Prediction scores s(n, m) for every model variant and foreign factors.

Reference: prediction_score / prediction_score_hier (hgaprec.cc:1850-1991)
and rating_likelihood[_hier] (1503-1560). Score = E[theta]·E[beta]
(+ bias expectations), with point-estimate matrices substituted for the
MLE/Canny variants, and imported factor matrices for the baseline bridges
(prediction_score_{nmf,lda,chi,ctr}, hgaprec.cc:1893-1966). Raw rate is
used as the ranking score (_use_rate_as_score = true, hgaprec.cc:30).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from hgaprec_jax import config as C
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.models.state import ModelState


class Scorer(NamedTuple):
    """score(n, m) = su[n]·sv[m] + bias_u[n] + bias_i[m] + global."""
    su: jax.Array                 # [N, K]
    sv: jax.Array                 # [M, K]
    bias_u: Optional[jax.Array]   # [N] or None
    bias_i: Optional[jax.Array]   # [M] or None
    global_off: float = 0.0       # chi bridge global mean (hgaprec.cc:1948)


def scorer_from_state(state: ModelState, cfg: ModelConfig) -> Scorer:
    if cfg.variant == C.VARIANT_MLE_USER:
        su, sv = state.theta_mle, state.beta.e
    elif cfg.variant in (C.VARIANT_MLE_ITEM, C.VARIANT_CANNY):
        su, sv = state.theta.e, state.beta_mle
    else:
        su, sv = state.theta.e, state.beta.e
    bu = state.theta_bias.e if cfg.bias else None
    bi = state.beta_bias.e if cfg.bias else None
    return Scorer(su, sv, bu, bi)


def scorer_from_foreign(theta, beta, bias_u=None, bias_i=None,
                        global_off: float = 0.0) -> Scorer:
    """Imported factors (NMF / LDA / graphchi / CTR bridges)."""
    return Scorer(jnp.asarray(theta), jnp.asarray(beta),
                  None if bias_u is None else jnp.asarray(bias_u),
                  None if bias_i is None else jnp.asarray(bias_i),
                  global_off)


@jax.jit
def _scores_full(sc: Scorer, users):
    s = jnp.dot(sc.su[users], sc.sv.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    if sc.bias_u is not None:
        s = s + sc.bias_u[users][:, None] + sc.bias_i[None, :]
    return s + sc.global_off


def user_scores(sc: Scorer, users: jax.Array) -> jax.Array:
    """[len(users), M] score matrix on device."""
    return _scores_full(sc, users)


@functools.partial(jax.jit, static_argnums=(4,))
def _pair_loglik(sc: Scorer, u, i, y, binary):
    s = jnp.sum(sc.su[u] * sc.sv[i], axis=1)
    if sc.bias_u is not None:
        s = s + sc.bias_u[u] + sc.bias_i[i]
    s = jnp.maximum(s + sc.global_off, 1e-30)  # floor (hgaprec.cc:1531)
    if binary:
        # y==0 ? -s : log(1 - exp(-s))   (hgaprec.cc:1533-1534)
        ll = jnp.where(y == 0, -s, jnp.log(-jnp.expm1(-s)))
    else:
        # y log s - s - log y!           (hgaprec.cc:1535, 1563-1570)
        ll = y * jnp.log(s) - s - jax.lax.lgamma(y + 1.0)
    return jnp.sum(ll), ll


def pair_loglik(sc: Scorer, u, i, y, binary: bool):
    """Total and per-pair heldout log-likelihood for (u, i, y) arrays."""
    return _pair_loglik(sc, u, i, y, binary)


@jax.jit
def _pair_scores(sc: Scorer, u, i):
    s = jnp.sum(sc.su[u] * sc.sv[i], axis=1)
    if sc.bias_u is not None:
        s = s + sc.bias_u[u] + sc.bias_i[i]
    return s + sc.global_off


def pair_scores(sc: Scorer, u, i):
    return _pair_scores(sc, u, i)
