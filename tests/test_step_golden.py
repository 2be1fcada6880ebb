"""Golden tests: jitted CAVI steps vs the literal NumPy reference model."""

import numpy as np
import pytest

import reference_impl as R
from conftest import make_synthetic

from hgaprec_jax.config import ModelConfig
from hgaprec_jax.data.device import build_device_data
from hgaprec_jax.models.state import init_state
from hgaprec_jax.models.step import make_step


def _cfg_dict(cfg: ModelConfig):
    return dict(a=cfg.a, b=cfg.b, c=cfg.c, d=cfg.d, ap=cfg.ap, bp=cfg.bp,
                cp=cfg.cp, dp=cfg.dp, vb=cfg.vb)


def _run_both(store, cfg, iters, step_ref, sweep_mode):
    cfg = ModelConfig(**{**cfg.__dict__, "sweep": sweep_mode})
    data = build_device_data(store, pad_multiple=128)
    state = init_state(cfg, seed=7)
    st = R.state_from_jax(state, cfg.variant, cfg.bias, cfg.hier)
    coo = list(zip(store.coo_u.tolist(), store.coo_i.tolist(),
                   store.coo_y.tolist()))
    step = make_step(cfg)
    for _ in range(iters):
        state = step(state, data)
        st = step_ref(st, coo)
    return state, st


def _assert_close(x, y, rtol, name):
    np.testing.assert_allclose(np.asarray(x, np.float64), y, rtol=rtol,
                               atol=1e-5, err_msg=name)


CASES = [
    ("bpf", {}, "segment"),
    ("bpf", {}, "dense"),
    ("bpf", {"bias": True}, "segment"),
    ("bpf", {"bias": True, "vb": False}, "dense"),
    ("bpf", {"binary": True}, "dense"),
    ("hpf", {}, "segment"),
    ("hpf", {}, "dense"),
    ("hpf", {"bias": True}, "dense"),
    ("mle_user", {}, "dense"),
    ("mle_item", {}, "dense"),
    ("canny", {}, "segment"),
]


@pytest.mark.parametrize("variant,kw,mode", CASES)
def test_step_matches_reference(rng, variant, kw, mode):
    binary = kw.get("binary", False)
    store, validation, test = make_synthetic(
        rng, n=25, m=19, k=0, density=0.4, binary=binary,
        rating_threshold=2 if binary else 1)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant=variant, **kw)

    if variant == "bpf":
        ref = lambda st, coo: R.bpf_step(st, coo, _cfg_dict(cfg))
    elif variant == "hpf":
        ref = lambda st, coo: R.hpf_step(st, coo, _cfg_dict(cfg))
    elif variant == "mle_user":
        ref = lambda st, coo: R.mle_user_step(st, coo, _cfg_dict(cfg))
    elif variant == "mle_item":
        ref = lambda st, coo: R.mle_item_step(st, coo, _cfg_dict(cfg))
    else:
        ref = lambda st, coo: R.mle_item_step(st, coo, _cfg_dict(cfg),
                                              canny=True)

    state, st = _run_both(store, cfg, iters=4, step_ref=ref, sweep_mode=mode)

    rtol = 5e-3  # f32 state iterated 4x vs f64
    if variant in ("bpf", "hpf"):
        _assert_close(state.theta.e, st["theta_e"], rtol, "theta_e")
        _assert_close(state.beta.e, st["beta_e"], rtol, "beta_e")
        _assert_close(state.theta.elog, st["theta_elog"], rtol, "theta_elog")
    if variant == "hpf":
        _assert_close(state.theta_rate.e, st["xi_e"], rtol, "xi_e")
        _assert_close(state.beta_rate.e, st["eta_e"], rtol, "eta_e")
    if cfg.bias:
        _assert_close(state.theta_bias.e, st["tbias_e"], rtol, "tbias_e")
        _assert_close(state.beta_bias.e, st["bbias_e"], rtol, "bbias_e")
    if variant == "mle_user":
        _assert_close(state.theta_mle, st["theta_mle"], rtol, "theta_mle")
        _assert_close(state.beta.e, st["beta_e"], rtol, "beta_e")
    if variant in ("mle_item", "canny"):
        _assert_close(state.beta_mle, st["beta_mle"], rtol, "beta_mle")
        _assert_close(state.theta.e, st["theta_e"], rtol, "theta_e")


def test_elbo_matches_reference(rng):
    store, validation, test = make_synthetic(rng, n=20, m=15, density=0.4)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant="hpf")
    state, st = _run_both(
        store, cfg, iters=3,
        step_ref=lambda s, coo: R.hpf_step(s, coo, _cfg_dict(cfg)),
        sweep_mode="segment")
    from hgaprec_jax.models.elbo import training_elbo
    data = build_device_data(store, pad_multiple=128)
    ours = float(training_elbo(state, data, cfg))
    coo = list(zip(store.coo_u.tolist(), store.coo_i.tolist(),
                   store.coo_y.tolist()))
    theirs = R.reference_elbo(st, coo, _cfg_dict(cfg))
    np.testing.assert_allclose(ours, theirs, rtol=1e-3)


@pytest.mark.parametrize("variant,kw", [
    ("bpf", {}), ("bpf", {"bias": True}), ("hpf", {}),
    ("bpf", {"binary": True}),
])
def test_true_elbo_monotone(rng, variant, kw):
    """CAVI correctness: the true ELBO must be non-decreasing."""
    binary = kw.get("binary", False)
    store, validation, test = make_synthetic(rng, n=30, m=25, density=0.35,
                                             binary=binary)
    cfg = ModelConfig(n=store.n, m=store.m, k=5, variant=variant, **kw)
    data = build_device_data(store, pad_multiple=128)
    state = init_state(cfg, seed=3)
    step = make_step(cfg)
    from hgaprec_jax.models.elbo import true_elbo
    vals = []
    for _ in range(15):
        state = step(state, data)
        vals.append(float(true_elbo(state, data, cfg)))
    diffs = np.diff(np.asarray(vals))
    # allow tiny f32 wiggle
    assert (diffs > -np.abs(np.asarray(vals[1:])) * 1e-5).all(), vals
