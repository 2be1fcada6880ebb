"""Unit tests for the Gamma-posterior primitives vs. hand/scipy values."""

import numpy as np
import jax.numpy as jnp

from hgaprec_jax.ops import gamma


def test_expectations_match_definition():
    shape = jnp.asarray([[0.5, 2.0], [3.0, 0.3]])
    rate = jnp.asarray([2.0, 4.0])
    e, elog = gamma.expectations(shape, rate)
    np.testing.assert_allclose(np.asarray(e),
                               np.asarray(shape) / np.asarray(rate)[None, :],
                               rtol=1e-6)
    # digamma(1) = -euler_gamma
    e2, elog2 = gamma.expectations(jnp.asarray([1.0]), jnp.asarray([1.0]))
    np.testing.assert_allclose(float(elog2[0]), -0.5772156649, atol=1e-5)


def test_make_nonzero_floor():
    x = jnp.asarray([0.0, -1.0, 2.0])
    out = np.asarray(gamma.make_nonzero(x))
    assert out[0] == 1e-30 and out[1] == 1e-30 and out[2] == 2.0


def test_host_digamma_matches_jax():
    x = np.asarray([0.01, 0.3, 0.31, 1.0, 2.5, 7.0, 100.0])
    ours = gamma._digamma_np(x)
    import jax
    theirs = np.asarray(jax.scipy.special.digamma(jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(ours, theirs, rtol=2e-5, atol=2e-5)


def test_elbo_term_scalar_prior():
    # one Gamma(a0,b0) prior with posterior == prior gives
    # E_q[log p(x)] - E_q[log q(x)] with q = p  =>  0
    shape = jnp.full((4, 3), 0.7)
    rate = jnp.full((3,), 1.3)
    e, elog = gamma.expectations(shape, rate)
    s = gamma.elbo_term(shape, rate, e, elog, 0.7, 1.3)
    np.testing.assert_allclose(float(s), 0.0, atol=1e-4)


def test_elbo_term_hier_rows_manual():
    import jax
    shape = jnp.asarray([[0.5, 0.9], [1.5, 2.0]])
    rate = jnp.asarray([[1.0, 2.0], [0.5, 1.0]])
    e, elog = gamma.expectations(shape, rate)
    prior_e = jnp.asarray([1.1, 0.7])
    prior_elog = jnp.log(prior_e) - 0.1
    s = float(gamma.elbo_term(shape, rate, e, elog, 0.3, prior_e, prior_elog))
    a0 = 0.3
    a = np.asarray(shape, np.float64); b = np.asarray(rate, np.float64)
    ev = np.asarray(e, np.float64); el = np.asarray(elog, np.float64)
    pe = np.asarray(prior_e, np.float64)[:, None]
    pl = np.asarray(prior_elog, np.float64)[:, None]
    import math
    expect = np.sum(a0 * pl + (a0 - 1) * el - pe * ev - math.lgamma(a0))
    expect -= np.sum(a * np.log(b) + (a - 1) * el - b * ev
                     - np.vectorize(math.lgamma)(a))
    np.testing.assert_allclose(s, expect, rtol=1e-4)


def test_init_distributions(rng):
    shape, rate, e, elog = gamma.init_matrix_gr(rng, 200, 8, 0.3, 0.3)
    s = np.asarray(shape)
    assert s.min() >= 0.3 and s.max() <= 0.31
    r = np.asarray(rate)
    assert r.shape == (8,) and r.min() >= 0.3 and r.max() <= 0.4
    # initial expectations use per-row random denominators in [0.3, 0.4]
    ee = np.asarray(e)
    assert (ee > 0.3 / 0.4 - 0.05).all() and (ee < 0.31 / 0.3 + 0.05).all()


def test_init_array2(rng):
    shape, rate, e, elog = gamma.init_array2(rng, 50, 0.3, 0.3, 7.0)
    np.testing.assert_allclose(np.asarray(rate), 7.3)
    np.testing.assert_allclose(np.asarray(e),
                               np.asarray(shape) / 7.3, rtol=1e-6)
