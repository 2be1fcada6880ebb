"""One CAVI iteration per model variant, as a pure jitted function.

Update *ordering* within an iteration is part of the algorithm and is kept
exactly as the reference stages it:

  * vb() (hgaprec.cc:919-980): theta rate uses old beta; theta swaps; beta
    rate uses the *new* theta (asymmetric staleness).
  * vb_bias() (1219-1319): same, plus bias shape slots; -novb switches to
    fully synchronous swaps (all rates from old expectations).
  * vb_hier() (1321-1436): per-row prior rates injected from the scale
    variables (set_prior_rate, gpbase.hh:163-173); scales update last from
    the *new* factor expectations.
  * vb_mle_user/item (982-1130) and vb_canny (1132-1216): one side is a
    point matrix renormalized per sweep (EM for GaP / Canny's GaP).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from hgaprec_jax import config as C
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.data.device import DeviceData
from hgaprec_jax.models.state import Gam, ModelState
from hgaprec_jax.ops.gamma import expectations
from hgaprec_jax.ops.sweep import sweep


def _gam(shape, rate, row_mask=None) -> Gam:
    """Gamma posterior with fresh expectations. `row_mask` zeroes the
    expectations of padding rows (sharding pads N to a device multiple) so
    they contribute nothing to cross-row reductions."""
    e, elog = expectations(shape, rate)
    if row_mask is not None:
        m = row_mask.reshape((-1,) + (1,) * (e.ndim - 1))
        e = e * m
    return Gam(shape=shape, rate=rate, e=e, elog=elog)


def _usum(x, axis_name):
    """Column sum over the (possibly device-sharded) user axis."""
    s = jnp.sum(x, axis=0)
    return lax.psum(s, axis_name) if axis_name else s


def _ipsum(x, axis_name):
    """All-reduce an item-side accumulator computed from local nonzeros."""
    return lax.psum(x, axis_name) if axis_name else x


def _bias_updates(cfg: ModelConfig, state: ModelState, res,
                  axis_name=None):
    """Bias Gamma(0.3, 0.3) updates: shape += y*phi[bias slot], rate =
    prior + count of opposite-side entities (update_rate_next_all,
    hgaprec.cc:1265-1270, gpbase.hh:231-237)."""
    tb = _gam(0.3 + res.acc_bias_a,
              jnp.full_like(state.theta_bias.rate, 0.3 + cfg.m))
    bb = _gam(0.3 + _ipsum(res.acc_bias_b, axis_name),
              jnp.full_like(state.beta_bias.rate, 0.3 + cfg.n))
    return tb, bb


def _resolve_mode(cfg: ModelConfig, data: DeviceData) -> str:
    mode = cfg.resolve_sweep()
    auto = cfg.sweep == C.SWEEP_AUTO
    if mode == C.SWEEP_DENSE and data.dense_y is None:
        mode = (C.SWEEP_HYBRID if data.head_dense_y is not None
                else C.SWEEP_SEGMENT)
    if auto and mode == C.SWEEP_SEGMENT:
        if data.dense_y is not None:
            mode = C.SWEEP_DENSE       # densified despite wide m: dense path
        elif data.head_dense_y is not None:
            mode = C.SWEEP_HYBRID      # head block built -> use it
    if mode == C.SWEEP_HYBRID and data.head_dense_y is None:
        mode = C.SWEEP_SEGMENT
    return mode


def cavi_step(state: ModelState, data: DeviceData, cfg: ModelConfig,
              axis_name: Optional[str] = None,
              row_mask: Optional[jax.Array] = None) -> ModelState:
    """One CAVI iteration. With `axis_name` (inside shard_map over a user-
    row mesh axis) the user-side tables and nonzeros are local shards, the
    item-side tables are replicated, and the only cross-device traffic is
    the psum of item-side sufficient statistics and K-length colsums —
    the parallel equivalent of the reference's (serial) factor sums
    (hgaprec.cc:944-956)."""
    mode = _resolve_mode(cfg, data)
    if cfg.variant == C.VARIANT_BPF:
        return _step_bpf(state, data, cfg, mode, axis_name, row_mask)
    if cfg.variant == C.VARIANT_HPF:
        return _step_hpf(state, data, cfg, mode, axis_name, row_mask)
    if cfg.variant == C.VARIANT_MLE_USER:
        return _step_mle_user(state, data, cfg, mode, axis_name, row_mask)
    if cfg.variant == C.VARIANT_MLE_ITEM:
        return _step_mle_item(state, data, cfg, mode, False, axis_name,
                              row_mask)
    if cfg.variant == C.VARIANT_CANNY:
        return _step_mle_item(state, data, cfg, mode, True, axis_name,
                              row_mask)
    raise ValueError(cfg.variant)


def _step_bpf(state, data, cfg, mode, axis_name=None, row_mask=None):
    eb_u = state.theta_bias.elog if cfg.bias else None
    eb_i = state.beta_bias.elog if cfg.bias else None
    res = sweep(state.theta.elog, state.beta.elog, eb_u, eb_i, data, mode,
                cfg.item_block, cfg.user_block, cfg.matmul_precision)

    betasum = jnp.sum(state.beta.e, axis=0)        # old beta [K], replicated
    theta = _gam(cfg.a + res.acc_a, cfg.b + betasum, row_mask)
    if cfg.vb:
        thetasum = _usum(theta.e, axis_name)                 # NEW theta [K]
    else:
        thetasum = _usum(state.theta.e, axis_name)           # -novb: old
    beta = _gam(cfg.c + _ipsum(res.acc_b, axis_name), cfg.d + thetasum)

    tb, bb = (None, None)
    if cfg.bias:
        tb, bb = _bias_updates(cfg, state, res, axis_name)
    return ModelState(theta=theta, beta=beta, theta_rate=None,
                      beta_rate=None, theta_bias=tb, beta_bias=bb,
                      theta_mle=None, beta_mle=None, theta_prior_e=None,
                      theta_prior_elog=None, beta_prior_e=None,
                      beta_prior_elog=None)


def _step_hpf(state, data, cfg, mode, axis_name=None, row_mask=None):
    eb_u = state.theta_bias.elog if cfg.bias else None
    eb_i = state.beta_bias.elog if cfg.bias else None
    res = sweep(state.theta.elog, state.beta.elog, eb_u, eb_i, data, mode,
                cfg.item_block, cfg.user_block, cfg.matmul_precision)

    # theta: prior rate := E[xi] per row (replacing b), plus old-beta colsum
    betarowsum = jnp.sum(state.beta.e, axis=0)     # [K], replicated
    xi = state.theta_rate
    theta = _gam(cfg.a + res.acc_a,
                 xi.e[:, None] + betarowsum[None, :], row_mask)
    # beta: symmetric with the NEW theta (hgaprec.cc:1380-1386)
    thetarowsum = _usum(theta.e, axis_name)
    eta = state.beta_rate
    beta = _gam(cfg.c + _ipsum(res.acc_b, axis_name),
                eta.e[:, None] + thetarowsum[None, :])

    tb, bb = (None, None)
    if cfg.bias:
        tb, bb = _bias_updates(cfg, state, res, axis_name)

    # scales last, from NEW factor expectations (hgaprec.cc:1398-1414):
    # shape = prior + K*prior; rate = prior + row-sums of E.
    theta_rate = _gam(
        jnp.full_like(xi.shape, cfg.ap + cfg.k * cfg.ap),
        cfg.bp + jnp.sum(theta.e, axis=1), row_mask)
    beta_rate = _gam(
        jnp.full_like(eta.shape, cfg.cp + cfg.k * cfg.cp),
        cfg.dp + jnp.sum(beta.e, axis=1))

    return ModelState(theta=theta, beta=beta, theta_rate=theta_rate,
                      beta_rate=beta_rate, theta_bias=tb, beta_bias=bb,
                      theta_mle=None, beta_mle=None,
                      # prior rates in effect for the updated theta/beta
                      theta_prior_e=xi.e, theta_prior_elog=xi.elog,
                      beta_prior_e=eta.e, beta_prior_elog=eta.elog)


def _step_mle_user(state, data, cfg, mode, axis_name=None, row_mask=None):
    log_td_old = jnp.log(state.theta_mle)
    res = sweep(log_td_old, state.beta.elog, None, None, data, mode,
                cfg.item_block, cfg.user_block, cfg.matmul_precision)
    betasum = jnp.sum(state.beta.e, axis=0)        # old beta [K], replicated
    td = res.acc_a / betasum[None, :]                        # EM normalize
    thetasum = _usum(td, axis_name)
    beta = _gam(cfg.c + _ipsum(res.acc_b, axis_name), cfg.d + thetasum)
    return ModelState(theta=state.theta, beta=beta, theta_rate=None,
                      beta_rate=None, theta_bias=None, beta_bias=None,
                      theta_mle=td, beta_mle=None, theta_prior_e=None,
                      theta_prior_elog=None, beta_prior_e=None,
                      beta_prior_elog=None)


def _step_mle_item(state, data, cfg, mode, canny: bool, axis_name=None,
                   row_mask=None):
    log_bd_old = jnp.log(state.beta_mle)
    res = sweep(state.theta.elog, log_bd_old, None, None, data, mode,
                cfg.item_block, cfg.user_block, cfg.matmul_precision)
    thetasum = _usum(state.theta.e, axis_name)               # old theta [K]
    acc_b = _ipsum(res.acc_b, axis_name)
    if canny:
        # floor *before* normalizing (hgaprec.cc:1173-1176), then per-factor
        # L1 column normalization (1179-1187)
        bd = jnp.maximum(acc_b, 1e-10) / thetasum[None, :]
        bd = bd / jnp.sum(bd, axis=0, keepdims=True)
    else:
        bd = acc_b / thetasum[None, :]
    betasum = jnp.sum(bd, axis=0)
    theta = _gam(cfg.a + res.acc_a, cfg.b + betasum, row_mask)
    return ModelState(theta=theta, beta=state.beta, theta_rate=None,
                      beta_rate=None, theta_bias=None, beta_bias=None,
                      theta_mle=None, beta_mle=bd, theta_prior_e=None,
                      theta_prior_elog=None, beta_prior_e=None,
                      beta_prior_elog=None)


@functools.partial(jax.jit, static_argnums=(2,), donate_argnums=(0,))
def _jitted_step(state, data, cfg):
    return cavi_step(state, data, cfg)


def make_step(cfg: ModelConfig):
    """Return a jitted `step(state, data) -> state` for this config."""
    def step(state: ModelState, data: DeviceData) -> ModelState:
        return _jitted_step(state, data, cfg)
    return step


def cavi_multi_step(state: ModelState, data: DeviceData, cfg: ModelConfig,
                    n_steps, axis_name: Optional[str] = None,
                    row_mask: Optional[jax.Array] = None) -> ModelState:
    """`n_steps` CAVI iterations inside one traced program.

    The reference re-enters its training loop from the host every
    iteration (hgaprec.cc:924-977); on an accelerator that per-dispatch
    host round trip dominates small/medium problems, so the engine fuses all
    iterations between two reporting points (rfreq of them) into one
    `lax.fori_loop` dispatch. `n_steps` may be a traced scalar — one
    compilation covers every chunk size."""
    def body(_, s):
        return cavi_step(s, data, cfg, axis_name, row_mask)
    return lax.fori_loop(0, n_steps, body, state)


@functools.partial(jax.jit, static_argnums=(3,), donate_argnums=(0,))
def _jitted_multi_step(state, data, n_steps, cfg):
    return cavi_multi_step(state, data, cfg, n_steps)


def make_multi_step(cfg: ModelConfig):
    """Return a jitted `multi_step(state, data, n_steps) -> state`."""
    def multi_step(state: ModelState, data: DeviceData,
                   n_steps: int) -> ModelState:
        return _jitted_multi_step(state, data, jnp.int32(n_steps), cfg)
    return multi_step
