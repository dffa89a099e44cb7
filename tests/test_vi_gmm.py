"""CAVI GMM demo (extras.vi_gmm) vs the reference's numpy behavior
(vae-cf/vi_gmm.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from recsys.extras import vi_gmm


def _numpy_cavi_step(data, phi, m, s2, sigma):
    """Oracle: the reference's update_bycavi (vi_gmm.py:34-43)."""
    e = np.outer(data, m) + (-0.5 * (m**2 + s2))[None, :]
    phi = np.exp(e) / np.sum(np.exp(e), axis=1)[:, None]
    m = np.sum(data[:, None] * phi, axis=0) / (
        1.0 / sigma**2 + np.sum(phi, axis=0)
    )
    s2 = 1.0 / (1.0 / sigma**2 + np.sum(phi, axis=0))
    return phi, m, s2


def test_cavi_step_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    data = rng.standard_normal(200).astype(np.float32)
    phi = rng.random((200, 3)).astype(np.float32)
    m = rng.standard_normal(3).astype(np.float32)
    s2 = rng.random(3).astype(np.float32) + 0.1
    sigma = 2.0

    state = vi_gmm.GmmState(
        jnp.asarray(phi), jnp.asarray(m), jnp.asarray(s2),
        jnp.asarray(-np.inf, jnp.float32), jnp.zeros((), jnp.int32),
    )
    out = vi_gmm.cavi_step(jnp.asarray(data), state, sigma)
    phi_np, m_np, s2_np = _numpy_cavi_step(
        data.astype(np.float64), phi.astype(np.float64),
        m.astype(np.float64), s2.astype(np.float64), sigma,
    )
    np.testing.assert_allclose(np.asarray(out.phi), phi_np, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.m), m_np, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.s2), s2_np, rtol=1e-5)


def test_fit_recovers_separated_means():
    key = jax.random.key(1)
    data = vi_gmm.sample_gmm(jax.random.key(2), [-4.0, 0.0, 4.0], 1.0, 500)
    final = vi_gmm.fit(key, data, 3, sigma=1.0, epsilon=1e-4, max_iters=500)
    means = np.sort(np.asarray(final.m))
    np.testing.assert_allclose(means, [-4.0, 0.0, 4.0], atol=0.25)
    assert int(final.it) < 500  # epsilon-converged, not iteration-capped


def test_elbo_monotone_nondecreasing():
    key = jax.random.key(3)
    data = vi_gmm.sample_gmm(jax.random.key(4), [0.0, 3.0], 1.0, 300)
    state = vi_gmm.cavi_step(data, vi_gmm.init_state(key, data, 2), 1.0)
    prev = float(state.elbo)
    for _ in range(10):
        state = vi_gmm.cavi_step(data, state, 1.0)
        cur = float(state.elbo)
        assert cur >= prev - 1e-3
        prev = cur


def test_reference_elbo_matches_reference_expression():
    rng = np.random.default_rng(5)
    data = rng.standard_normal(50)
    phi = rng.random((50, 2))
    phi /= phi.sum(axis=1, keepdims=True)
    m = rng.standard_normal(2)
    s2 = rng.random(2) + 0.1
    sigma = 2.0
    # reference compute_elbo (vi_gmm.py:25-32)
    p1 = -np.sum((m**2 + s2) / (2 * sigma**2))
    p2 = (-0.5 * np.add.outer(data**2, m**2 + s2) + np.outer(data, m)) * phi
    p3 = -np.sum(np.log(phi))
    p4 = np.sum(0.5 * np.sum(np.log(s2)))
    want = p1 + np.sum(p2) + p3 + p4

    state = vi_gmm.GmmState(
        jnp.asarray(phi, jnp.float32), jnp.asarray(m, jnp.float32),
        jnp.asarray(s2, jnp.float32), jnp.asarray(0.0), jnp.zeros((), jnp.int32),
    )
    got = float(vi_gmm.reference_elbo(jnp.asarray(data, jnp.float32), state,
                                      sigma))
    np.testing.assert_allclose(got, want, rtol=1e-4)
