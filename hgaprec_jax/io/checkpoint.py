"""Checkpoint I/O.

Two formats:

  * Reference-compatible TSVs — save_state() writes `{name}.tsv` (E[v]),
    `{name}_shape.tsv`, `{name}_rate.tsv` with rows
    `seq \t externalID \t v0 ... vK-1` at %.8f (gpbase.hh:389-398,
    matrix.hh:1140-1166; 1-D arrays via matrix.hh:726-744). Family names
    match the reference: theta/beta (BPF), htheta/hbeta/thetarate/betarate
    (HPF), thetabias/betabias, theta_mle/beta_mle.
  * A native .npz with the complete state + iteration counter, enabling
    resume-into-training (the reference cannot: -load only feeds ranking
    modes, hgaprec.cc:2088-2094).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from hgaprec_jax import config as C
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.models.state import Gam, ModelState
from hgaprec_jax.ops.gamma import expectations


def _id_of(idmap: Dict[int, int], i: int) -> int:
    return idmap.get(i, i)


def _save_mat(path: str, x: np.ndarray, idmap: Dict[int, int]) -> None:
    x = np.atleast_2d(np.asarray(x))
    if x.shape[0] == 1 and x.size > 1:
        x = x.T  # 1-D arrays saved one value per row (matrix.hh:726-744)
    ext = np.fromiter((_id_of(idmap, i) for i in range(x.shape[0])),
                      np.int64, x.shape[0])
    # native threaded writer (native/fastsave.cc); Python fallback below
    from hgaprec_jax.data import native
    if native.write_tsv_mat(path, x.astype(np.float32, copy=False), ext):
        return
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            vals = "\t".join(f"{v:.8f}" for v in x[i])
            f.write(f"{i}\t{int(ext[i])}\t{vals}\n")


def _load_mat(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows.append([float(v) for v in parts[2:]])
    return np.asarray(rows, dtype=np.float64)


def save_gam_tsv(outdir: str, name: str, g: Gam,
                 idmap: Dict[int, int]) -> None:
    """GP*::save_state (gpbase.hh:389-398, 743-752, 971-980)."""
    _save_mat(os.path.join(outdir, f"{name}.tsv"), np.asarray(g.e), idmap)
    _save_mat(os.path.join(outdir, f"{name}_shape.tsv"),
              np.asarray(g.shape), idmap)
    _save_mat(os.path.join(outdir, f"{name}_rate.tsv"),
              np.asarray(g.rate), idmap)


def save_model_tsv(outdir: str, state: ModelState, cfg: ModelConfig,
                   seq2user: Dict[int, int], seq2movie: Dict[int, int]
                   ) -> None:
    """HGAPRec::save_model (hgaprec.cc:2137-2158)."""
    if cfg.hier:
        save_gam_tsv(outdir, "hbeta", state.beta, seq2movie)
        save_gam_tsv(outdir, "betarate", state.beta_rate, seq2movie)
        save_gam_tsv(outdir, "htheta", state.theta, seq2user)
        save_gam_tsv(outdir, "thetarate", state.theta_rate, seq2user)
    else:
        save_gam_tsv(outdir, "beta", state.beta, seq2movie)
        save_gam_tsv(outdir, "theta", state.theta, seq2user)
    if cfg.bias:
        save_gam_tsv(outdir, "betabias", state.beta_bias, seq2movie)
        save_gam_tsv(outdir, "thetabias", state.theta_bias, seq2user)
    if cfg.mle:
        if state.theta_mle is not None:
            _save_mat(os.path.join(outdir, "theta_mle.tsv"),
                      np.asarray(state.theta_mle), seq2user)
        if state.beta_mle is not None:
            _save_mat(os.path.join(outdir, "beta_mle.tsv"),
                      np.asarray(state.beta_mle), seq2movie)


def load_model_tsv(indir: str, cfg: ModelConfig,
                   template: ModelState) -> ModelState:
    """HGAPRec::load_beta_and_theta (hgaprec.cc:2114-2135).

    Reference semantics: non-hier GPMatrixGR loads shape+rate and
    recomputes expectations... actually GPMatrixGR::load does
    (gpbase.hh:754-764); plain GPMatrix::load reads only E[v]
    (gpbase.hh:410-415). We follow each family's own loader.
    """
    dt = cfg.dtype

    def load_gr(name: str, g: Gam) -> Gam:
        shape = _load_mat(os.path.join(indir, f"{name}_shape.tsv"))
        rate = _load_mat(os.path.join(indir, f"{name}_rate.tsv")).ravel()
        e, elog = expectations(jnp.asarray(shape, dt), jnp.asarray(rate, dt))
        return Gam(jnp.asarray(shape, dt), jnp.asarray(rate, dt), e, elog)

    def load_mat_rate(name: str, g: Gam) -> Gam:
        shape = _load_mat(os.path.join(indir, f"{name}_shape.tsv"))
        rate = _load_mat(os.path.join(indir, f"{name}_rate.tsv"))
        if np.asarray(g.rate).ndim == 1:
            rate = rate.ravel()
        e, elog = expectations(jnp.asarray(shape, dt), jnp.asarray(rate, dt))
        return Gam(jnp.asarray(shape, dt), jnp.asarray(rate, dt), e, elog)

    def load_ev_only(name: str, g: Gam) -> Gam:
        e = _load_mat(os.path.join(indir, f"{name}.tsv"))
        e = e.ravel() if np.asarray(g.e).ndim == 1 else e
        return Gam(g.shape, g.rate, jnp.asarray(e, dt), g.elog)

    kw = dict(theta_rate=template.theta_rate, beta_rate=template.beta_rate,
              theta_bias=template.theta_bias, beta_bias=template.beta_bias,
              theta_mle=template.theta_mle, beta_mle=template.beta_mle,
              theta_prior_e=template.theta_prior_e,
              theta_prior_elog=template.theta_prior_elog,
              beta_prior_e=template.beta_prior_e,
              beta_prior_elog=template.beta_prior_elog)
    if cfg.hier:
        kw["theta_rate"] = load_mat_rate("thetarate", template.theta_rate)
        kw["beta_rate"] = load_mat_rate("betarate", template.beta_rate)
        theta = load_mat_rate("htheta", template.theta)
        beta = load_mat_rate("hbeta", template.beta)
    else:
        theta = load_gr("theta", template.theta)
        beta = load_gr("beta", template.beta)
    if cfg.bias:
        kw["theta_bias"] = load_ev_only("thetabias", template.theta_bias)
        kw["beta_bias"] = load_ev_only("betabias", template.beta_bias)
    if cfg.mle:
        if template.theta_mle is not None:
            kw["theta_mle"] = jnp.asarray(
                _load_mat(os.path.join(indir, "theta_mle.tsv")), dt)
        if template.beta_mle is not None:
            kw["beta_mle"] = jnp.asarray(
                _load_mat(os.path.join(indir, "beta_mle.tsv")), dt)
    return ModelState(theta=theta, beta=beta, **kw)


# -- native full-fidelity checkpoint ---------------------------------------

_FIELDS = ("theta", "beta", "theta_rate", "beta_rate", "theta_bias",
           "beta_bias")


def save_npz(path: str, state: ModelState, iteration: int) -> None:
    """Derived parts (e/elog) may be None — e.g. the sharded trainer
    gathers only shape/rate to the host (parallel/sharded.py) — and are
    then recomputed from shape/rate on load."""
    arrs = {"iteration": np.asarray(iteration)}
    for f in _FIELDS:
        g: Optional[Gam] = getattr(state, f)
        if g is None:
            continue
        for part in ("shape", "rate", "e", "elog"):
            v = getattr(g, part)
            if v is not None:
                arrs[f"{f}.{part}"] = np.asarray(v)
    for f in ("theta_mle", "beta_mle", "theta_prior_e", "theta_prior_elog",
              "beta_prior_e", "beta_prior_elog"):
        v = getattr(state, f)
        if v is not None:
            arrs[f] = np.asarray(v)
    np.savez(path, **arrs)


def load_npz(path: str, cfg: ModelConfig):
    """Returns (state, iteration)."""
    z = np.load(path)
    dt = cfg.dtype

    def gam(f):
        if f"{f}.shape" not in z:
            return None
        shape = jnp.asarray(z[f"{f}.shape"], dt)
        rate = jnp.asarray(z[f"{f}.rate"], dt)
        if f"{f}.e" in z and f"{f}.elog" in z:
            return Gam(shape, rate, jnp.asarray(z[f"{f}.e"], dt),
                       jnp.asarray(z[f"{f}.elog"], dt))
        e, elog = expectations(shape, rate)
        return Gam(shape, rate, e, elog)

    def arr(f):
        return jnp.asarray(z[f], dt) if f in z else None

    state = ModelState(
        theta=gam("theta"), beta=gam("beta"), theta_rate=gam("theta_rate"),
        beta_rate=gam("beta_rate"), theta_bias=gam("theta_bias"),
        beta_bias=gam("beta_bias"), theta_mle=arr("theta_mle"),
        beta_mle=arr("beta_mle"), theta_prior_e=arr("theta_prior_e"),
        theta_prior_elog=arr("theta_prior_elog"),
        beta_prior_e=arr("beta_prior_e"),
        beta_prior_elog=arr("beta_prior_elog"))
    return state, int(z["iteration"])
