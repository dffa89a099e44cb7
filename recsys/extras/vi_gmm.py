"""CAVI for a Gaussian mixture — variational-inference teaching demo.

JAX counterpart of the reference's standalone demo
(vae-cf/vi_gmm.py:11-87): coordinate-ascent variational inference for a
K-component univariate GMM with known, shared observation variance and a
N(0, sigma²) prior on the component means.

Where the reference mutates numpy state in a Python loop with a
convergence ``break`` (vi_gmm.py:45-59), this version is a single jitted
``lax.while_loop`` over an immutable state tuple — the whole fit is one XLA
program, so it runs on-device (the per-iteration [N, K] responsibilities
matrix is VPU-shaped elementwise work plus two tiny contractions).

Math (identical to vi_gmm.py:34-43):
    phi_ik ∝ exp(x_i·m_k − (m_k² + s2_k)/2)            (responsibilities)
    m_k    = Σ_i phi_ik·x_i / (1/sigma² + Σ_i phi_ik)  (mean update)
    s2_k   = 1 / (1/sigma² + Σ_i phi_ik)               (variance update)
with the reference's ELBO expression (vi_gmm.py:25-32) — including its
``−Σ log phi`` entropy-sign quirk — available separately as
`reference_elbo`, and a standard ELBO (`elbo`) used for convergence.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class GmmState(NamedTuple):
    phi: jax.Array   # [N, K] responsibilities
    m: jax.Array     # [K] variational means
    s2: jax.Array    # [K] variational variances
    elbo: jax.Array  # [] current ELBO
    it: jax.Array    # [] iteration counter


def init_state(key: jax.Array, data: jax.Array, num_clusters: int) -> GmmState:
    """Random init mirroring vi_gmm.py:16-23: uniform phi, means drawn
    inside the data range, uniform s2."""
    n = data.shape[0]
    k_phi, k_m, k_s2 = jax.random.split(key, 3)
    phi = jax.random.uniform(k_phi, (n, num_clusters))
    m = jax.random.uniform(
        k_m, (num_clusters,), minval=jnp.min(data), maxval=jnp.max(data)
    )
    s2 = jax.random.uniform(k_s2, (num_clusters,))
    return GmmState(phi, m, s2, jnp.asarray(-jnp.inf, jnp.float32),
                    jnp.zeros((), jnp.int32))


def cavi_step(data: jax.Array, state: GmmState, sigma: float) -> GmmState:
    """One coordinate-ascent sweep (vi_gmm.py:34-43)."""
    e = jnp.outer(data, state.m) - 0.5 * (state.m**2 + state.s2)[None, :]
    phi = jax.nn.softmax(e, axis=1)
    denom = 1.0 / sigma**2 + jnp.sum(phi, axis=0)
    m = (data @ phi) / denom
    s2 = 1.0 / denom
    new = GmmState(phi, m, s2, state.elbo, state.it + 1)
    return new._replace(elbo=elbo(data, new, sigma))


def elbo(data: jax.Array, state: GmmState, sigma: float) -> jax.Array:
    """Standard mean-field ELBO (up to additive constants in x)."""
    phi, m, s2 = state.phi, state.m, state.s2
    p_mean = -jnp.sum((m**2 + s2) / (2.0 * sigma**2))
    ll = jnp.sum(
        phi * (jnp.outer(data, m) - 0.5 * (m**2 + s2)[None, :])
    )
    ent_c = -jnp.sum(phi * jnp.log(jnp.clip(phi, 1e-12)))
    ent_mu = 0.5 * jnp.sum(jnp.log(s2))
    return p_mean + ll + ent_c + ent_mu


def reference_elbo(data: jax.Array, state: GmmState, sigma: float) -> jax.Array:
    """The reference's exact ELBO expression, quirks included
    (vi_gmm.py:25-32: ``p3 = −Σ log phi`` rather than −Σ phi·log phi)."""
    phi, m, s2 = state.phi, state.m, state.s2
    p1 = -jnp.sum((m**2 + s2) / (2.0 * sigma**2))
    p2 = jnp.sum(
        (-0.5 * (data[:, None] ** 2 + (m**2 + s2)[None, :])
         + jnp.outer(data, m)) * phi
    )
    p3 = -jnp.sum(jnp.log(jnp.clip(phi, 1e-12)))
    p4 = 0.5 * jnp.sum(jnp.log(s2))
    return p1 + p2 + p3 + p4


@partial(jax.jit, static_argnames=("num_clusters", "max_iters"))
def fit(
    key: jax.Array,
    data: jax.Array,
    num_clusters: int,
    *,
    sigma: float = 1.0,
    epsilon: float = 1e-3,
    max_iters: int = 1000,
) -> GmmState:
    """CAVI to epsilon-convergence of the ELBO (vi_gmm.py:45-59), as one
    jitted while_loop. Returns the final state (``state.it`` = sweeps run)."""
    state0 = cavi_step(data, init_state(key, data, num_clusters), sigma)

    def cond(carry):
        prev_elbo, state = carry
        return (jnp.abs(state.elbo - prev_elbo) > epsilon) & (
            state.it < max_iters
        )

    def body(carry):
        _, state = carry
        return state.elbo, cavi_step(data, state, sigma)

    _, final = jax.lax.while_loop(cond, body, (jnp.inf, state0))
    return final


def sample_gmm(key: jax.Array, means, sigma: float, n_per_cluster: int):
    """The demo's data generator (vi_gmm.py:73-82): n samples per cluster."""
    means = jnp.asarray(means, jnp.float32)
    eps = jax.random.normal(key, (means.shape[0], n_per_cluster))
    return (means[:, None] + sigma * eps).reshape(-1)
