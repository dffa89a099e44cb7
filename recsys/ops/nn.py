"""Dense-tower primitives: dense / MLP / batch-norm / dropout.

Functional equivalents of the reference's ``tf.layers.dense`` +
``tf.layers.batch_normalization`` + ``tf.layers.dropout`` towers
(deepfm/deepfm.py:100-108, dcn/dcn.py:144-149, xdeepfm/xdeepfm.py:188-192).

Initializer parity with TF1 defaults:
- dense kernel: glorot_uniform, bias: zeros (tf.layers.dense defaults);
- batch_norm: momentum 0.99, epsilon 1e-3 (tf.layers defaults).

Note on fidelity: the reference never runs ``tf.GraphKeys.UPDATE_OPS``, so
its BN moving statistics never actually update (a classic TF1 estimator bug);
we implement *correct* BN (moving stats updated each train step) rather than
reproducing the bug.

Everything here is jit-friendly: static shapes, no Python control flow on
traced values. XLA fuses the BN/dropout/activation elementwise tail around
the matmuls.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

Params = dict[str, Any]
State = dict[str, Any]

BN_MOMENTUM = 0.99
BN_EPS = 1e-3


# ---------------------------------------------------------------------------
# initializers (TF1-default parity)
# ---------------------------------------------------------------------------

def glorot_uniform(key, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[0], shape[-1]
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return jax.random.uniform(key, shape, dtype, -limit, limit)


def glorot_normal(key, shape, dtype=jnp.float32):
    fan_in = shape[0] if len(shape) > 1 else shape[0]
    fan_out = shape[-1] if len(shape) > 1 else shape[0]
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return std * jax.random.normal(key, shape, dtype)


def truncated_normal(key, shape, stddev, dtype=jnp.float32):
    return stddev * jax.random.truncated_normal(key, -2.0, 2.0, shape, dtype)


def embedding_init(key, shape, dtype=jnp.float32):
    """tf.feature_column.embedding_column default:
    truncated_normal(stddev=1/sqrt(embedding_dim))."""
    dim = shape[-1]
    return truncated_normal(key, shape, 1.0 / (dim ** 0.5), dtype)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dense_init(key, in_dim: int, out_dim: int, dtype=jnp.float32) -> Params:
    kw, _ = jax.random.split(key)
    return {
        "w": glorot_uniform(kw, (in_dim, out_dim), dtype),
        "b": jnp.zeros((out_dim,), dtype),
    }


def dense(params: Params, x, activation=None) -> jax.Array:
    """``x`` may be a list/tuple of [B, d_i] pieces with Σd_i = in_dim: the
    kernel is applied per piece against its static row slice and the
    partial products summed — mathematically identical to
    ``dense(concat(x))`` but the concatenated activation (and its
    cotangent) never materializes. The embedding engines hand out their
    small/big parts separately for exactly this (engines.EmbParts)."""
    if isinstance(x, (list, tuple)):
        w = params["w"]
        lo = 0
        y = None
        for piece in x:
            d = piece.shape[-1]
            part = jnp.dot(piece, w[lo:lo + d],
                           preferred_element_type=jnp.float32)
            y = part if y is None else y + part
            lo += d
        y = y + params["b"]
    else:
        y = jnp.dot(x, params["w"],
                    preferred_element_type=jnp.float32) + params["b"]
    if activation is not None:
        y = activation(y)
    return y


# ---------------------------------------------------------------------------
# batch norm (train returns updated moving stats)
# ---------------------------------------------------------------------------

def bn_init(dim: int, dtype=jnp.float32) -> tuple[Params, State]:
    params = {"scale": jnp.ones((dim,), dtype), "offset": jnp.zeros((dim,), dtype)}
    state = {"mean": jnp.zeros((dim,), dtype), "var": jnp.ones((dim,), dtype)}
    return params, state


def batch_norm(
    params: Params, state: State, x: jax.Array, train: bool
) -> tuple[jax.Array, State]:
    if train:
        mean = jnp.mean(x, axis=0)
        var = jnp.var(x, axis=0)
        new_state = {
            "mean": BN_MOMENTUM * state["mean"] + (1 - BN_MOMENTUM) * mean,
            "var": BN_MOMENTUM * state["var"] + (1 - BN_MOMENTUM) * var,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = jax.lax.rsqrt(var + BN_EPS)
    y = (x - mean) * inv * params["scale"] + params["offset"]
    return y, new_state


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def dropout(key, x: jax.Array, rate: float, train: bool) -> jax.Array:
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)


# ---------------------------------------------------------------------------
# MLP tower: [dense -> relu -> bn -> dropout] x N  (reference ordering)
# ---------------------------------------------------------------------------

def mlp_init(
    key, in_dim: int, layer_dims: tuple[int, ...], use_bn: bool = True,
    dtype=jnp.float32,
) -> tuple[Params, State]:
    params: Params = {"layers": []}
    state: State = {"layers": []}
    d = in_dim
    for i, h in enumerate(layer_dims):
        key, sub = jax.random.split(key)
        layer_p: Params = {"dense": dense_init(sub, d, h, dtype)}
        layer_s: State = {}
        if use_bn:
            bp, bs = bn_init(h, dtype)
            layer_p["bn"] = bp
            layer_s["bn"] = bs
        params["layers"].append(layer_p)
        state["layers"].append(layer_s)
        d = h
    return params, state


def mlp_apply(
    params: Params,
    state: State,
    x: jax.Array,
    *,
    train: bool,
    dropout_rate: float = 0.0,
    rng: jax.Array | None = None,
) -> tuple[jax.Array, State]:
    """Reference tower ordering: dense+relu, then BN, then dropout
    (deepfm/deepfm.py:103-107)."""
    new_state: State = {"layers": []}
    h = x
    for i, layer_p in enumerate(params["layers"]):
        h = dense(layer_p["dense"], h, activation=jax.nn.relu)
        layer_s = state["layers"][i] if state["layers"] else {}
        new_layer_s: State = {}
        if "bn" in layer_p:
            h, bn_s = batch_norm(layer_p["bn"], layer_s["bn"], h, train)
            new_layer_s["bn"] = bn_s
        if dropout_rate > 0.0 and train:
            assert rng is not None, "mlp dropout needs an rng in train mode"
            rng, sub = jax.random.split(rng)
            h = dropout(sub, h, dropout_rate, train)
        new_state["layers"].append(new_layer_s)
    return h, new_state
