"""Model state as an immutable pytree of Gamma posteriors.

Replaces the reference's GPMatrix/GPMatrixGR/GPArray curr/next double
buffers (/root/reference/src/gpbase.hh): one CAVI iteration returns a new
state, which *is* the reference's swap() discipline, functionally.

Each `Gam` carries the posterior (shape, rate) plus the current
expectations (e, elog). Expectations are carried — not recomputed from
shape/rate on demand — because the reference's initial expectations are
deliberately decorrelated from the initial posterior (initialize_exp uses
fresh random rates, gpbase.hh:324-340); after the first update they are
always digamma-consistent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from hgaprec_jax import config as cfg_mod
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.ops import gamma


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Gam:
    shape: jax.Array   # [N, K] or [N]
    rate: jax.Array    # [K] (global), [N, K] (per-entry), or [N]
    e: jax.Array       # same shape as `shape`
    elog: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ModelState:
    theta: Gam                     # users x K (variational; unused by mle_user)
    beta: Gam                      # items x K (variational; unused by mle_item/canny)
    theta_rate: Optional[Gam]      # HPF user activity xi [N]
    beta_rate: Optional[Gam]       # HPF item popularity eta [M]
    theta_bias: Optional[Gam]      # [N]
    beta_bias: Optional[Gam]       # [M]
    theta_mle: Optional[jax.Array]  # [N, K] point estimate (mle_user)
    beta_mle: Optional[jax.Array]   # [M, K] point estimate (mle_item/canny)
    # HPF ELBO parity: per-row prior rates in effect for theta/beta, i.e.
    # the E[xi]/Elog[xi] captured at update time (set_prior_rate,
    # gpbase.hh:163-173) — consumed by the hier ELBO term
    # (gpbase.hh:360-373).
    theta_prior_e: Optional[jax.Array]
    theta_prior_elog: Optional[jax.Array]
    beta_prior_e: Optional[jax.Array]
    beta_prior_elog: Optional[jax.Array]


def init_state(cfg: ModelConfig, seed: int = 0) -> ModelState:
    """Reference HGAPRec::initialize() (hgaprec.cc:153-204).

    RNG draw *order* follows the reference so that runs are reproducible
    under a fixed seed (GSL replaced by NumPy; distributional parity).
    """
    rng = np.random.default_rng(seed)
    n, m, k = cfg.n, cfg.m, cfg.k
    dt = cfg.dtype

    theta = beta = None
    theta_rate = beta_rate = None
    theta_mle = beta_mle = None
    if not cfg.hier:
        # beta first, then theta (hgaprec.cc:156-160)
        beta = Gam(*gamma.init_matrix_gr(rng, m, k, cfg.c, cfg.d, dt))
        theta = Gam(*gamma.init_matrix_gr(rng, n, k, cfg.a, cfg.b, dt))
    else:
        # thetarate/betarate via initialize2(k) (hgaprec.cc:173-178), then
        # hbeta, then htheta (hgaprec.cc:184-192)
        theta_rate = Gam(*gamma.init_array2(rng, n, cfg.ap, cfg.bp, float(k), dt))
        beta_rate = Gam(*gamma.init_array2(rng, m, cfg.cp, cfg.dp, float(k), dt))
        beta = Gam(*gamma.init_matrix(rng, m, k, cfg.c, cfg.d, dt))
        theta = Gam(*gamma.init_matrix(rng, n, k, cfg.a, cfg.b, dt))

    theta_bias = beta_bias = None
    if cfg.bias:
        # thetabias.initialize2(M), betabias.initialize2(N)
        # (hgaprec.cc:196-202); stored flattened to [N]/[M].
        s, r, e, el = gamma.init_matrix2(rng, n, 1, 0.3, 0.3, float(m), dt)
        theta_bias = Gam(s[:, 0], r[:, 0], e[:, 0], el[:, 0])
        s, r, e, el = gamma.init_matrix2(rng, m, 1, 0.3, 0.3, float(n), dt)
        beta_bias = Gam(s[:, 0], r[:, 0], e[:, 0], el[:, 0])

    if cfg.variant == cfg_mod.VARIANT_MLE_USER:
        # old_td = 1/K (hgaprec.cc:988-991)
        theta_mle = jax.numpy.full((n, k), 1.0 / k, dt)
    elif cfg.variant == cfg_mod.VARIANT_MLE_ITEM:
        beta_mle = jax.numpy.full((m, k), 1.0 / k, dt)
    elif cfg.variant == cfg_mod.VARIANT_CANNY:
        # old_bd = 1/M (hgaprec.cc:1139-1141)
        beta_mle = jax.numpy.full((m, k), 1.0 / m, dt)

    tpe = tpel = bpe = bpel = None
    if cfg.hier:
        # before the first update the prior rates in effect are the
        # initialized scale expectations. Copies, not aliases: a state with
        # two leaves sharing one buffer cannot be donated to the jitted step
        # ("attempt to donate the same buffer twice").
        tpe, tpel = jax.numpy.array(theta_rate.e), jax.numpy.array(
            theta_rate.elog)
        bpe, bpel = jax.numpy.array(beta_rate.e), jax.numpy.array(
            beta_rate.elog)

    return ModelState(theta=theta, beta=beta, theta_rate=theta_rate,
                      beta_rate=beta_rate, theta_bias=theta_bias,
                      beta_bias=beta_bias, theta_mle=theta_mle,
                      beta_mle=beta_mle, theta_prior_e=tpe,
                      theta_prior_elog=tpel, beta_prior_e=bpe,
                      beta_prior_elog=bpel)
