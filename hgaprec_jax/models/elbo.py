"""Training ELBO — reference logl() (hgaprec.cc:2160-2255), device-side.

The reference recomputes phi per nonzero and accumulates
    sum_k y*phi_k*(Elog theta + Elog beta - log phi_k)
where phi has already been scaled by y when y > 1 (so the formula is
evaluated with phi_s = y*phi). Algebraically that inner sum collapses:
with phi_s = y*softmax(logits),
    sum_j y*phi_s_j*(logit_j - log phi_s_j) = y^2 * (lse - log y)
(for y = 1 this is just lse). The same collapse absorbs the bias slots
(hgaprec.cc:2228-2231). So the data term needs only one logsumexp per
nonzero — a matmul row reduction — plus the expected-rate dot products
over nonzeros, and the per-family Gamma terms (gpbase.hh:360-387).

This reproduces the reference's reported quantity exactly, including its
quirks: the y^2 scaling (an artifact of re-using the scaled phi) and the
-E[theta]E[beta] term summed over *nonzeros only* rather than all pairs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hgaprec_jax import config as C
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.data.device import DeviceData
from hgaprec_jax.models.state import ModelState
from hgaprec_jax.ops.gamma import elbo_term


@functools.partial(jax.jit, static_argnums=(2,))
def training_elbo(state: ModelState, data: DeviceData,
                  cfg: ModelConfig) -> jax.Array:
    theta, beta = state.theta, state.beta
    bias = cfg.bias
    elog_t, elog_b = theta.elog, beta.elog

    logits = elog_t[data.u_ids] + elog_b[data.i_ids]
    if bias:
        logits = jnp.concatenate(
            [logits, state.theta_bias.elog[data.u_ids][:, None],
             state.beta_bias.elog[data.i_ids][:, None]], axis=1)
    lse = jax.scipy.special.logsumexp(logits, axis=1)
    y = data.y
    live = y > 0
    logy = jnp.where(y > 1, jnp.log(jnp.maximum(y, 1.0)), 0.0)
    s = jnp.sum(jnp.where(live, y * y * (lse - logy), 0.0))

    # -sum over nonzeros of E[theta]E[beta] (+ bias expectations)
    rate = jnp.sum(theta.e[data.u_ids] * beta.e[data.i_ids], axis=1)
    if bias:
        rate = rate + state.theta_bias.e[data.u_ids] \
            + state.beta_bias.e[data.i_ids]
    s -= jnp.sum(jnp.where(live, rate, 0.0))

    # per-family Gamma ELBO terms
    if not cfg.hier:
        s += elbo_term(theta.shape, theta.rate, theta.e, theta.elog,
                       cfg.a, cfg.b)
        s += elbo_term(beta.shape, beta.rate, beta.e, beta.elog,
                       cfg.c, cfg.d)
    else:
        # hier prior rates: E[xi]/Elog[xi] captured at update time
        # (gpbase.hh:360-373 via set_prior_rate)
        s += elbo_term(theta.shape, theta.rate, theta.e, theta.elog,
                       cfg.a, state.theta_prior_e, state.theta_prior_elog)
        s += elbo_term(beta.shape, beta.rate, beta.e, beta.elog,
                       cfg.c, state.beta_prior_e, state.beta_prior_elog)
        xi, eta = state.theta_rate, state.beta_rate
        s += elbo_term(xi.shape, xi.rate, xi.e, xi.elog, cfg.ap, cfg.bp)
        s += elbo_term(eta.shape, eta.rate, eta.e, eta.elog, cfg.cp, cfg.dp)
    if bias:
        tb, bb = state.theta_bias, state.beta_bias
        s += elbo_term(tb.shape, tb.rate, tb.e, tb.elog, 0.3, 0.3)
        s += elbo_term(bb.shape, bb.rate, bb.e, bb.elog, 0.3, 0.3)
    return s


@functools.partial(jax.jit, static_argnums=(2,))
def true_elbo(state: ModelState, data: DeviceData,
              cfg: ModelConfig) -> jax.Array:
    """The actual Poisson-factorization ELBO (not the reference's report).

    With the multinomial responsibilities phi set to their exact coordinate
    optimum, the data term is sum_nz (y*lse - log y!) and the Poisson mass
    term runs over ALL pairs: sum_k colsum(E theta)_k * colsum(E beta)_k
    (+ full bias mass). Used for monotonicity property tests — exact CAVI
    must never decrease this quantity across full update rounds.
    """
    theta, beta = state.theta, state.beta
    logits = theta.elog[data.u_ids] + beta.elog[data.i_ids]
    if cfg.bias:
        logits = jnp.concatenate(
            [logits, state.theta_bias.elog[data.u_ids][:, None],
             state.beta_bias.elog[data.i_ids][:, None]], axis=1)
    lse = jax.scipy.special.logsumexp(logits, axis=1)
    y = data.y
    live = y > 0
    s = jnp.sum(jnp.where(live,
                          y * lse - jax.lax.lgamma(jnp.maximum(y, 1.0) + 1.0),
                          0.0))
    s -= jnp.sum(jnp.sum(theta.e, axis=0) * jnp.sum(beta.e, axis=0))
    if cfg.bias:
        s -= cfg.m * jnp.sum(state.theta_bias.e)
        s -= cfg.n * jnp.sum(state.beta_bias.e)
    if not cfg.hier:
        s += elbo_term(theta.shape, theta.rate, theta.e, theta.elog,
                       cfg.a, cfg.b)
        s += elbo_term(beta.shape, beta.rate, beta.e, beta.elog,
                       cfg.c, cfg.d)
    else:
        xi, eta = state.theta_rate, state.beta_rate
        s += elbo_term(theta.shape, theta.rate, theta.e, theta.elog,
                       cfg.a, xi.e, xi.elog)
        s += elbo_term(beta.shape, beta.rate, beta.e, beta.elog,
                       cfg.c, eta.e, eta.elog)
        s += elbo_term(xi.shape, xi.rate, xi.e, xi.elog, cfg.ap, cfg.bp)
        s += elbo_term(eta.shape, eta.rate, eta.e, eta.elog, cfg.cp, cfg.dp)
    if cfg.bias:
        tb, bb = state.theta_bias, state.beta_bias
        s += elbo_term(tb.shape, tb.rate, tb.e, tb.elog, 0.3, 0.3)
        s += elbo_term(bb.shape, bb.rate, bb.e, bb.elog, 0.3, 0.3)
    return s
