"""Multi-DAE / Multi-VAE^PR / Logistic-VAE collaborative filtering.

JAX re-design of vae-cf/vae_cf_model.py:

- MultiDAE (vae_cf_model.py:15-99): L2-normalized dropout-corrupted input →
  tanh MLP autoencoder → multinomial log-likelihood.
- MultiVAE (vae_cf_model.py:102-232): encoder emits mu‖logvar
  (:144-164), reparameterized z = mu + is_training·ε·σ (:177-188), loss =
  neg_ll + β·KL + 2·λ·l2 (:119-133) with the β anneal schedule owned by the
  trainer (vae_cf_train_val.py:184-187: β = min(cap, step/anneal_steps)).
- Logistic-VAE: the commented alternative likelihood (vae_cf_model.py:
  121-123) — per-entry sigmoid cross-entropy on the decoder output.

Weight init parity: xavier (glorot_uniform) kernels, truncated-normal(0.001)
biases (vae_cf_model.py:86-96, 205-232).

Shape notes: the whole per-batch graph (two small MLPs + softmax over ~20k
items) is a handful of matmuls; batches of users are dense [B, I]
float32 staged by the trainer; eval NDCG runs on-device via lax.top_k
(`recsys.train.metrics`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from recsys.ops import nn


class VaeParams(NamedTuple):
    q_weights: list     # encoder [(w,b), ...]
    p_weights: list     # decoder [(w,b), ...]


def _layer_init(key, d_in, d_out):
    kw, kb = jax.random.split(key)
    return {
        "w": nn.glorot_uniform(kw, (d_in, d_out)),
        "b": nn.truncated_normal(kb, (d_out,), 0.001),
    }


def _mlp_chain(layers, h, final_linear=True):
    for i, lp in enumerate(layers):
        h = h @ lp["w"] + lp["b"]
        if i != len(layers) - 1 or not final_linear:
            h = jnp.tanh(h)
    return h


def l2_normalize(x, axis=1, eps=1e-12):
    return x / jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=axis, keepdims=True),
                                    eps))


def make_multi_dae(p_dims: tuple[int, ...], lam: float = 0.01):
    """p_dims e.g. (200, 600, n_items); q_dims is the reverse
    (vae_cf_model.py:17-24)."""
    q_dims = tuple(reversed(p_dims))
    dims = q_dims + p_dims[1:]

    def init(key):
        layers = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            key, sub = jax.random.split(key)
            layers.append(_layer_init(sub, d_in, d_out))
        return {"layers": layers}

    def apply(params, x, *, train=False, rng=None, keep_prob=0.5):
        h = l2_normalize(x, axis=1)
        if train and rng is not None:
            h = nn.dropout(rng, h, 1.0 - keep_prob, True)
        logits = _mlp_chain(params["layers"], h)
        return logits

    def loss_fn(params, x, *, rng=None, train=True, keep_prob=0.5):
        logits = apply(params, x, train=train, rng=rng, keep_prob=keep_prob)
        log_softmax = jax.nn.log_softmax(logits)
        neg_ll = -jnp.mean(jnp.sum(log_softmax * x, axis=1))
        reg = sum(jnp.sum(lp["w"] ** 2) for lp in params["layers"])
        # reference: 2 * l2_regularizer(lam) == lam * Σ‖W‖²
        return neg_ll + lam * reg, {"neg_ll": neg_ll}

    return init, apply, loss_fn


def make_multi_vae(p_dims: tuple[int, ...], lam: float = 0.0,
                   likelihood: str = "multinomial"):
    """MultiVAE^PR (lam=0.0 as the reference's best run) or Logistic-VAE
    (likelihood='logistic')."""
    q_dims = tuple(reversed(p_dims))
    latent = p_dims[0]

    def init(key):
        q_layers = []
        for i, (d_in, d_out) in enumerate(zip(q_dims[:-1], q_dims[1:])):
            if i == len(q_dims) - 2:
                d_out *= 2      # mu ‖ logvar (vae_cf_model.py:195-198)
            key, sub = jax.random.split(key)
            q_layers.append(_layer_init(sub, d_in, d_out))
        p_layers = []
        for d_in, d_out in zip(p_dims[:-1], p_dims[1:]):
            key, sub = jax.random.split(key)
            p_layers.append(_layer_init(sub, d_in, d_out))
        return {"q": q_layers, "p": p_layers}

    def encode(params, x, *, train=False, rng=None, keep_prob=0.5):
        h = l2_normalize(x, axis=1)
        if train and rng is not None:
            rng_drop, _ = jax.random.split(rng)
            h = nn.dropout(rng_drop, h, 1.0 - keep_prob, True)
        h = _mlp_chain(params["q"], h)
        mu, logvar = h[:, :latent], h[:, latent:]
        kl = jnp.mean(jnp.sum(
            0.5 * (-logvar + jnp.exp(logvar) + mu ** 2 - 1.0), axis=1))
        return mu, logvar, kl

    def apply(params, x, *, train=False, rng=None, keep_prob=0.5):
        mu, logvar, kl = encode(params, x, train=train, rng=rng,
                                keep_prob=keep_prob)
        if train and rng is not None:
            _, rng_eps = jax.random.split(rng)
            eps = jax.random.normal(rng_eps, mu.shape)
            z = mu + eps * jnp.exp(0.5 * logvar)
        else:
            z = mu   # is_training_ph defaults to 0 at scoring
        logits = _mlp_chain(params["p"], z)
        return logits, kl

    def loss_fn(params, x, anneal, *, rng=None, train=True, keep_prob=0.5):
        logits, kl = apply(params, x, train=train, rng=rng,
                           keep_prob=keep_prob)
        if likelihood == "multinomial":
            log_softmax = jax.nn.log_softmax(logits)
            neg_ll = -jnp.mean(jnp.sum(log_softmax * x, axis=1))
        elif likelihood == "logistic":
            ce = (jnp.maximum(logits, 0) - logits * x
                  + jnp.log1p(jnp.exp(-jnp.abs(logits))))
            neg_ll = jnp.mean(jnp.sum(ce, axis=1))
        else:
            raise ValueError(likelihood)
        reg = sum(jnp.sum(lp["w"] ** 2)
                  for lp in params["q"] + params["p"])
        neg_elbo = neg_ll + anneal * kl + lam * reg
        return neg_elbo, {"neg_ll": neg_ll, "kl": kl}

    return init, apply, loss_fn


def anneal_schedule(step: int, cap: float = 0.2,
                    total_anneal_steps: int = 200_000) -> float:
    """β = min(cap, step/total) (vae_cf_train_val.py:79-81,184-187)."""
    if total_anneal_steps > 0:
        return min(cap, 1.0 * step / total_anneal_steps)
    return cap
