"""Optimizers: Adam (TF-parity) and FTRL-proximal, as pure pytree updates.

Self-contained (init, update) pairs in the optax style but with a state
layout that is a plain mirror of the params tree — this keeps sharding-spec
construction for the SPMD path trivial (mu/nu inherit the exact
PartitionSpec of their parameter).

- `adam` reproduces ``tf.train.AdamOptimizer`` (deepfm/deepfm.py:142)
  *exactly*: update = lr·√(1−β2ᵗ)/(1−β1ᵗ) · m / (√v + ε̂) — note TF keeps a
  single ε̂ outside the bias correction, unlike optax's ε-inside-denominator
  variant; the difference is tiny but this removes one source of drift in
  parity runs.
- `ftrl` is the FTRL-proximal update of ftrl/ftrl.py:153-181 (z/n
  accumulators, lazy L1/L2 weights), vectorized over dense tensors — the
  optimizer behind the reference's canned LinearClassifier as well.

Row-sparse embedding updates — decision note (SURVEY §7.3). We deliberately
run the DENSE update over the whole table: with the reference's 100k-capped
vocabs the packed table is 840,648×17 f32 stored flat, and one dense Adam
pass streams it and its two moments once per step. A row-sparse update
would gather + scatter the mu/nu/param rows for the ~250k unique ids of a
batch instead; which is faster on the GPU is not measured yet (ROADMAP).
At full-vocab scale (45M rows, ~9 GB of Adam state)
the right move is not sparsity but sharding: the SPMD path row-shards the
table AND its optimizer state over the 'model' axis (parallel/spmd.py
opt_specs), so each chip's dense pass shrinks by the axis size.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


class Optimizer(NamedTuple):
    init: Any
    update: Any   # update(grads, state, params) -> (new_params, new_state)


class AdamState(NamedTuple):
    count: jax.Array
    mu: Any
    nu: Any


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """``learning_rate`` may be a float or a callable ``lr(t)`` of the
    1-based float step (schedules — see `cosine_decay`). ``weight_decay``
    adds decoupled (AdamW-style) decay scaled by the scheduled lr."""
    def init(params) -> AdamState:
        zeros = lambda p: jnp.zeros_like(p)
        return AdamState(
            count=jnp.zeros((), jnp.int32),
            mu=jax.tree.map(zeros, params),
            nu=jax.tree.map(zeros, params),
        )

    def update(grads, state: AdamState, params):
        count = state.count + 1
        t = count.astype(jnp.float32)
        lr = learning_rate(t) if callable(learning_rate) else learning_rate
        lr_t = lr * jnp.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        mu = jax.tree.map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = jax.tree.map(lambda v, g: b2 * v + (1 - b2) * g * g,
                          state.nu, grads)
        if weight_decay:
            new_params = jax.tree.map(
                lambda p, m, v: p - lr_t * m / (jnp.sqrt(v) + eps)
                - lr * weight_decay * p,
                params, mu, nu,
            )
        else:
            new_params = jax.tree.map(
                lambda p, m, v: p - lr_t * m / (jnp.sqrt(v) + eps),
                params, mu, nu,
            )
        return new_params, AdamState(count, mu, nu)

    return Optimizer(init, update)


def cosine_decay(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                 floor: float = 0.0):
    """lr(t): linear warmup to ``peak_lr`` then cosine decay to
    ``floor·peak_lr`` at ``total_steps``. Online one-pass SGD is
    noise-limited near convergence (the Adam noise ball scales with lr), so
    decaying to ~0 at the example budget is what closes the last few
    millipoints of AUC to the planted ceiling (tools/converge.py)."""
    peak = jnp.float32(peak_lr)
    total = max(total_steps, 1)

    def lr(t):
        warm = peak * t / jnp.maximum(warmup_steps, 1)
        frac = jnp.clip((t - warmup_steps) / max(total - warmup_steps, 1),
                        0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + jnp.cos(jnp.pi * frac))
        return jnp.where(t < warmup_steps, warm, peak * cos)

    return lr


class FtrlState(NamedTuple):
    z: Any   # per-weight z accumulator (ftrl/ftrl.py:50 "z: weights")
    n: Any   # per-weight squared-gradient sum


def ftrl(alpha: float = 0.1, beta: float = 1.0, l1: float = 1.0,
         l2: float = 1.0) -> Optimizer:
    """FTRL-proximal. ``params`` here are the *lazy* weights w derived from
    (z, n) (ftrl/ftrl.py:109-151); update() recomputes them after each step
    so models can keep treating params as plain tensors."""

    def weights_from(z, n):
        sign = jnp.sign(z)
        w = (sign * l1 - z) / ((beta + jnp.sqrt(n)) / alpha + l2)
        return jnp.where(jnp.abs(z) <= l1, 0.0, w)

    def init(params) -> FtrlState:
        return FtrlState(
            z=jax.tree.map(jnp.zeros_like, params),
            n=jax.tree.map(jnp.zeros_like, params),
        )

    def update(grads, state: FtrlState, params):
        z_new = jax.tree.map(
            lambda z, n, g, w: z + g - (jnp.sqrt(n + g * g) - jnp.sqrt(n))
            / alpha * w,
            state.z, state.n, grads, params,
        )
        n_new = jax.tree.map(lambda n, g: n + g * g, state.n, grads)
        new_params = jax.tree.map(weights_from, z_new, n_new)
        return new_params, FtrlState(z_new, n_new)

    return Optimizer(init, update)


def for_model(model_meta: dict, learning_rate: float) -> Optimizer:
    """The optimizer a model declares via ``Model.meta['optimizer']``:
    'ftrl' for the wide/linear model (the reference's canned
    LinearClassifier is FTRL-backed with NO L1/L2 regularization — TF's
    LinearClassifier defaults — deep&wide/deep&wide.py:146-149; the
    regularized per-example FTRL of ftrl/ftrl.py lives in
    models/ftrl_lr.py), TF-parity Adam otherwise (deepfm/deepfm.py:142)."""
    if model_meta.get("optimizer") == "ftrl":
        return ftrl(alpha=learning_rate, l1=0.0, l2=0.0)
    return adam(learning_rate)
