"""Fused multi-iteration dispatch == repeated single steps.

The engine runs all iterations between two reporting points inside one
lax.fori_loop dispatch (models/step.py::cavi_multi_step); the trajectory
must be identical to stepping one iteration at a time — fusing the host
loop is an execution detail, not an algorithm change.
"""

import numpy as np
import pytest
import jax

from conftest import make_synthetic
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.data.device import build_device_data
from hgaprec_jax.models.state import init_state
from hgaprec_jax.models.step import make_multi_step, make_step
from hgaprec_jax.parallel.sharded import build_sharded_run, make_mesh


@pytest.mark.parametrize("variant,kw", [
    ("bpf", {}),
    ("bpf", {"bias": True, "vb": False}),
    ("hpf", {}),
    ("hpf", {"bias": True}),
    ("mle_user", {}),
    ("mle_item", {}),
    ("canny", {}),
])
@pytest.mark.parametrize("sweep", ["dense", "segment"])
def test_multi_step_matches_single(rng, variant, kw, sweep):
    store, _, _ = make_synthetic(rng, n=37, m=23, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant=variant,
                      sweep=sweep, **kw)
    data = build_device_data(store, pad_multiple=64)

    step = make_step(cfg)
    s1 = init_state(cfg, seed=7)
    for _ in range(5):
        s1 = step(s1, data)

    multi = make_multi_step(cfg)
    s2 = multi(init_state(cfg, seed=7), data, 5)

    for name, a, b in (("theta_e", s1.theta.e, s2.theta.e),
                       ("beta_e", s1.beta.e, s2.beta.e)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    if variant == "hpf":
        np.testing.assert_allclose(np.asarray(s1.theta_rate.e),
                                   np.asarray(s2.theta_rate.e), rtol=1e-6)
    if variant == "mle_user":
        np.testing.assert_allclose(np.asarray(s1.theta_mle),
                                   np.asarray(s2.theta_mle), rtol=1e-6)
    if variant in ("mle_item", "canny"):
        np.testing.assert_allclose(np.asarray(s1.beta_mle),
                                   np.asarray(s2.beta_mle), rtol=1e-6)


def test_multi_step_dynamic_trip_count_single_compile(rng):
    """n_steps is a traced scalar: chunk sizes 1/3/7 share one executable."""
    store, _, _ = make_synthetic(rng, n=20, m=15)
    cfg = ModelConfig(n=store.n, m=store.m, k=3, variant="bpf")
    data = build_device_data(store, pad_multiple=64)
    multi = make_multi_step(cfg)
    step = make_step(cfg)

    s_ref = init_state(cfg, seed=3)
    for _ in range(11):
        s_ref = step(s_ref, data)
    s = init_state(cfg, seed=3)
    for n in (1, 3, 7):
        s = multi(s, data, n)
    np.testing.assert_allclose(np.asarray(s.theta.e),
                               np.asarray(s_ref.theta.e), rtol=1e-6)


def test_sharded_multi_step_matches_single(rng):
    assert len(jax.devices()) == 8
    store, _, _ = make_synthetic(rng, n=53, m=31, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant="hpf")

    run1 = build_sharded_run(store, cfg, make_mesh(), seed=11,
                             pad_multiple=128)
    for _ in range(4):
        run1.step()
    a = run1.unsharded_state()

    run2 = build_sharded_run(store, cfg, make_mesh(), seed=11,
                             pad_multiple=128)
    run2.multi_step(4)
    b = run2.unsharded_state()

    np.testing.assert_allclose(np.asarray(a.theta.e), np.asarray(b.theta.e),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(a.beta.e), np.asarray(b.beta.e),
                               rtol=1e-6, atol=1e-8)
