"""Literal NumPy (float64) transcription of the reference CAVI semantics.

Each function restates the corresponding /root/reference/src/hgaprec.cc
training loop body with explicit Python loops over nonzeros — slow, but
unambiguous — to serve as the golden model for the jitted steps.
State dict keys mirror the Gam pytree: shape/rate/e/elog per family.
"""

import numpy as np

try:
    from scipy.special import digamma as _psi  # not guaranteed present
except Exception:
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from hgaprec_jax.ops.gamma import _digamma_np as _psi


def expectations(shape, rate):
    a = np.where(shape > 0, shape, 1e-30)
    b = np.where(np.broadcast_to(rate, a.shape) > 0,
                 np.broadcast_to(rate, a.shape), 1e-30)
    return a / b, _psi(a) - np.log(b)


def phi_of(elog_t, elog_b, n, m, bias_u=None, bias_i=None):
    logits = elog_t[n] + elog_b[m]
    if bias_u is not None:
        logits = np.concatenate([logits, [bias_u[n]], [bias_i[m]]])
    ex = np.exp(logits - logits.max())
    return ex / ex.sum()


def bpf_step(st, coo, cfg):
    """vb() body (hgaprec.cc:928-956); also vb_bias() with bias=True
    (1228-1297), honoring the vb/novb swap orderings."""
    n_users = st["theta_e"].shape[0]
    n_items = st["beta_e"].shape[0]
    k = st["theta_e"].shape[1]
    bias = "tbias_e" in st
    acc_t = np.zeros((n_users, k))
    acc_b = np.zeros((n_items, k))
    acc_bt = np.zeros(n_users)
    acc_bb = np.zeros(n_items)
    for (n, m, y) in coo:
        phi = phi_of(st["theta_elog"], st["beta_elog"], n, m,
                     st.get("tbias_elog"), st.get("bbias_elog"))
        phi = phi * y if y > 1 else phi
        acc_t[n] += phi[:k]
        acc_b[m] += phi[:k]
        if bias:
            acc_bt[n] += phi[k]
            acc_bb[m] += phi[k + 1]

    a, b, c, d = cfg["a"], cfg["b"], cfg["c"], cfg["d"]
    if cfg.get("vb", True):
        betasum = st["beta_e"].sum(0)
        st["theta_shape"] = a + acc_t
        st["theta_rate"] = b + betasum
        st["theta_e"], st["theta_elog"] = expectations(
            st["theta_shape"], st["theta_rate"])
        thetasum = st["theta_e"].sum(0)
        st["beta_shape"] = c + acc_b
        st["beta_rate"] = d + thetasum
        st["beta_e"], st["beta_elog"] = expectations(
            st["beta_shape"], st["beta_rate"])
    else:
        betasum = st["beta_e"].sum(0)
        thetasum = st["theta_e"].sum(0)
        st["theta_shape"] = a + acc_t
        st["theta_rate"] = b + betasum
        st["beta_shape"] = c + acc_b
        st["beta_rate"] = d + thetasum
        st["theta_e"], st["theta_elog"] = expectations(
            st["theta_shape"], st["theta_rate"])
        st["beta_e"], st["beta_elog"] = expectations(
            st["beta_shape"], st["beta_rate"])
    if bias:
        st["tbias_shape"] = 0.3 + acc_bt
        st["tbias_rate"] = np.full(n_users, 0.3 + n_items)
        st["tbias_e"], st["tbias_elog"] = expectations(
            st["tbias_shape"], st["tbias_rate"])
        st["bbias_shape"] = 0.3 + acc_bb
        st["bbias_rate"] = np.full(n_items, 0.3 + n_users)
        st["bbias_e"], st["bbias_elog"] = expectations(
            st["bbias_shape"], st["bbias_rate"])
    return st


def hpf_step(st, coo, cfg):
    """vb_hier() body (hgaprec.cc:1340-1414)."""
    n_users, k = st["theta_e"].shape
    n_items = st["beta_e"].shape[0]
    bias = "tbias_e" in st
    acc_t = np.zeros((n_users, k))
    acc_b = np.zeros((n_items, k))
    acc_bt = np.zeros(n_users)
    acc_bb = np.zeros(n_items)
    for (n, m, y) in coo:
        phi = phi_of(st["theta_elog"], st["beta_elog"], n, m,
                     st.get("tbias_elog"), st.get("bbias_elog"))
        phi = phi * y if y > 1 else phi
        acc_t[n] += phi[:k]
        acc_b[m] += phi[:k]
        if bias:
            acc_bt[n] += phi[k]
            acc_bb[m] += phi[k + 1]

    a, c = cfg["a"], cfg["c"]
    ap, bp, cp, dp = cfg["ap"], cfg["bp"], cfg["cp"], cfg["dp"]
    betarowsum = st["beta_e"].sum(0)
    st["theta_prior_e"] = st["xi_e"].copy()
    st["theta_prior_elog"] = st["xi_elog"].copy()
    st["theta_shape"] = a + acc_t
    st["theta_rate"] = st["xi_e"][:, None] + betarowsum[None, :]
    st["theta_e"], st["theta_elog"] = expectations(
        st["theta_shape"], st["theta_rate"])

    thetarowsum = st["theta_e"].sum(0)
    st["beta_prior_e"] = st["eta_e"].copy()
    st["beta_prior_elog"] = st["eta_elog"].copy()
    st["beta_shape"] = c + acc_b
    st["beta_rate"] = st["eta_e"][:, None] + thetarowsum[None, :]
    st["beta_e"], st["beta_elog"] = expectations(
        st["beta_shape"], st["beta_rate"])

    if bias:
        st["tbias_shape"] = 0.3 + acc_bt
        st["tbias_rate"] = np.full(n_users, 0.3 + n_items)
        st["tbias_e"], st["tbias_elog"] = expectations(
            st["tbias_shape"], st["tbias_rate"])
        st["bbias_shape"] = 0.3 + acc_bb
        st["bbias_rate"] = np.full(n_items, 0.3 + n_users)
        st["bbias_e"], st["bbias_elog"] = expectations(
            st["bbias_shape"], st["bbias_rate"])

    st["xi_shape"] = np.full(n_users, ap + k * ap)
    st["xi_rate"] = bp + st["theta_e"].sum(1)
    st["xi_e"], st["xi_elog"] = expectations(st["xi_shape"], st["xi_rate"])
    st["eta_shape"] = np.full(n_items, cp + k * cp)
    st["eta_rate"] = dp + st["beta_e"].sum(1)
    st["eta_e"], st["eta_elog"] = expectations(st["eta_shape"],
                                               st["eta_rate"])
    return st


def mle_user_step(st, coo, cfg):
    """vb_mle_user() body (hgaprec.cc:995-1035)."""
    n_users, k = st["theta_mle"].shape
    n_items = st["beta_e"].shape[0]
    td = np.zeros((n_users, k))
    acc_b = np.zeros((n_items, k))
    log_old = np.log(st["theta_mle"])
    for (n, m, y) in coo:
        phi = phi_of(log_old, st["beta_elog"], n, m)
        phi = phi * y if y > 1 else phi
        td[n] += phi
        acc_b[m] += phi
    betasum = st["beta_e"].sum(0)
    td = td / betasum[None, :]
    thetasum = td.sum(0)
    st["beta_shape"] = cfg["c"] + acc_b
    st["beta_rate"] = cfg["d"] + thetasum
    st["beta_e"], st["beta_elog"] = expectations(st["beta_shape"],
                                                 st["beta_rate"])
    st["theta_mle"] = td
    return st


def mle_item_step(st, coo, cfg, canny=False):
    """vb_mle_item() (1059-1130) / vb_canny() (1132-1216) body."""
    n_items, k = st["beta_mle"].shape
    n_users = st["theta_e"].shape[0]
    bd = np.zeros((n_items, k))
    acc_t = np.zeros((n_users, k))
    log_old = np.log(st["beta_mle"])
    for (n, m, y) in coo:
        phi = phi_of(st["theta_elog"], log_old, n, m)
        phi = phi * y if y > 1 else phi
        bd[m] += phi
        acc_t[n] += phi
    thetasum = st["theta_e"].sum(0)
    if canny:
        bd = np.where(bd < 1e-10, 1e-10, bd)
        bd = bd / thetasum[None, :]
        bd = bd / bd.sum(0, keepdims=True)
    else:
        bd = bd / thetasum[None, :]
    betasum = bd.sum(0)
    st["theta_shape"] = cfg["a"] + acc_t
    st["theta_rate"] = cfg["b"] + betasum
    st["theta_e"], st["theta_elog"] = expectations(st["theta_shape"],
                                                   st["theta_rate"])
    st["beta_mle"] = bd
    return st


def reference_elbo(st, coo, cfg):
    """logl() (hgaprec.cc:2160-2255) with its exact quirks."""
    import math
    k = st["theta_e"].shape[1]
    bias = "tbias_e" in st
    s = 0.0
    for (n, m, y) in coo:
        phi = phi_of(st["theta_elog"], st["beta_elog"], n, m,
                     st.get("tbias_elog"), st.get("bbias_elog"))
        phi = phi * y if y > 1 else phi
        v = 0.0
        for kk in range(k):
            v += y * phi[kk] * (st["theta_elog"][n, kk]
                                + st["beta_elog"][m, kk] - np.log(phi[kk]))
        s += v
        if bias:
            s += y * phi[k] * (st["tbias_elog"][n] - np.log(phi[k]))
            s += y * phi[k + 1] * (st["bbias_elog"][m] - np.log(phi[k + 1]))
        s -= float(st["theta_e"][n] @ st["beta_e"][m])
        if bias:
            s -= st["tbias_e"][n] + st["bbias_e"][m]

    def family(shape, rate, e, elog, sp, rp, rlog=None):
        a = np.where(shape > 0, shape, 1e-30)
        b = np.where(np.broadcast_to(rate, a.shape) > 0,
                     np.broadcast_to(rate, a.shape), 1e-30)
        rp = np.broadcast_to(rp, a.shape[0] if a.ndim == 1 else (a.shape[0],))
        if rlog is None:
            rlog = np.log(rp)
        rpb = rp[:, None] if a.ndim > 1 else rp
        rlb = np.asarray(rlog)[:, None] if a.ndim > 1 else np.asarray(rlog)
        t = np.sum(sp * rlb + (sp - 1) * elog - rpb * e - math.lgamma(sp))
        t -= np.sum(a * np.log(b) + (a - 1) * elog - b * e
                    - np.vectorize(math.lgamma)(a))
        return t

    hier = "xi_e" in st
    if not hier:
        s += family(st["theta_shape"], st["theta_rate"], st["theta_e"],
                    st["theta_elog"], cfg["a"], cfg["b"])
        s += family(st["beta_shape"], st["beta_rate"], st["beta_e"],
                    st["beta_elog"], cfg["c"], cfg["d"])
    else:
        s += family(st["theta_shape"], st["theta_rate"], st["theta_e"],
                    st["theta_elog"], cfg["a"], st["theta_prior_e"],
                    st["theta_prior_elog"])
        s += family(st["beta_shape"], st["beta_rate"], st["beta_e"],
                    st["beta_elog"], cfg["c"], st["beta_prior_e"],
                    st["beta_prior_elog"])
        s += family(st["xi_shape"], st["xi_rate"], st["xi_e"],
                    st["xi_elog"], cfg["ap"], cfg["bp"])
        s += family(st["eta_shape"], st["eta_rate"], st["eta_e"],
                    st["eta_elog"], cfg["cp"], cfg["dp"])
    if bias:
        s += family(st["tbias_shape"], st["tbias_rate"], st["tbias_e"],
                    st["tbias_elog"], 0.3, 0.3)
        s += family(st["bbias_shape"], st["bbias_rate"], st["bbias_e"],
                    st["bbias_elog"], 0.3, 0.3)
    return s


def state_from_jax(state, cfg_variant, bias, hier):
    """Convert a hgaprec_jax ModelState to the dict form."""
    st = {}
    g = state.theta
    st["theta_shape"] = np.asarray(g.shape, np.float64)
    st["theta_rate"] = np.asarray(g.rate, np.float64)
    st["theta_e"] = np.asarray(g.e, np.float64)
    st["theta_elog"] = np.asarray(g.elog, np.float64)
    g = state.beta
    st["beta_shape"] = np.asarray(g.shape, np.float64)
    st["beta_rate"] = np.asarray(g.rate, np.float64)
    st["beta_e"] = np.asarray(g.e, np.float64)
    st["beta_elog"] = np.asarray(g.elog, np.float64)
    if hier:
        for key, g in (("xi", state.theta_rate), ("eta", state.beta_rate)):
            st[f"{key}_shape"] = np.asarray(g.shape, np.float64)
            st[f"{key}_rate"] = np.asarray(g.rate, np.float64)
            st[f"{key}_e"] = np.asarray(g.e, np.float64)
            st[f"{key}_elog"] = np.asarray(g.elog, np.float64)
        st["theta_prior_e"] = np.asarray(state.theta_prior_e, np.float64)
        st["theta_prior_elog"] = np.asarray(state.theta_prior_elog,
                                            np.float64)
        st["beta_prior_e"] = np.asarray(state.beta_prior_e, np.float64)
        st["beta_prior_elog"] = np.asarray(state.beta_prior_elog, np.float64)
    if bias:
        for key, g in (("tbias", state.theta_bias),
                       ("bbias", state.beta_bias)):
            st[f"{key}_shape"] = np.asarray(g.shape, np.float64)
            st[f"{key}_rate"] = np.asarray(g.rate, np.float64)
            st[f"{key}_e"] = np.asarray(g.e, np.float64)
            st[f"{key}_elog"] = np.asarray(g.elog, np.float64)
    if state.theta_mle is not None:
        st["theta_mle"] = np.asarray(state.theta_mle, np.float64)
    if state.beta_mle is not None:
        st["beta_mle"] = np.asarray(state.beta_mle, np.float64)
    return st
