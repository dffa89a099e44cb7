"""Train state + jit-compiled train/eval step factories.

Replaces the reference's estimator train_op assembly
(``tf.train.AdamOptimizer(lr).minimize(loss)`` — deepfm/deepfm.py:142-143 and
clones) and MirroredStrategy replication with a single pjit-compiled step:

- the full step (embedding gather → interaction math → loss → backward →
  Adam update) is ONE XLA program; with batch inputs sharded over the 'data'
  mesh axis and parameters replicated, XLA inserts the gradient all-reduce
  over ICI automatically (the NCCL replacement, SURVEY §2.2 row 2);
- donated arguments make the parameter/optimizer buffers update in place
  (no HBM traffic for a second copy);
- the optimizer is the SAME TF-parity Adam (`recsys.train.optim.adam`)
  the SPMD path uses — one implementation, so sharded-vs-local equivalence
  tests exercise the production update rule.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from recsys.models.api import Model
from recsys.train import metrics as M
from recsys.train import optim


class TrainState(NamedTuple):
    params: Any
    model_state: Any       # BN moving stats etc.
    opt_state: Any
    step: jax.Array        # scalar int32
    rng: jax.Array         # root key; per-step keys are folded in


def sigmoid_ce(logits: jax.Array, labels: jax.Array) -> jax.Array:
    """Numerically-stable mean sigmoid cross-entropy
    (tf.nn.sigmoid_cross_entropy_with_logits parity, deepfm/deepfm.py:126-129)."""
    labels = labels.astype(jnp.float32)
    per_ex = (
        jnp.maximum(logits, 0.0)
        - logits * labels
        + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    )
    return jnp.mean(per_ex)


def create_train_state(
    model: Model, seed: int, learning_rate: float,
    opt: optim.Optimizer | None = None,
) -> tuple[TrainState, optim.Optimizer]:
    key = jax.random.key(seed)
    init_key, run_key = jax.random.split(key)
    params, model_state = model.init(init_key)
    tx = opt if opt is not None else optim.for_model(model.meta, learning_rate)
    opt_state = tx.init(params)
    return (
        TrainState(params, model_state, opt_state, jnp.zeros((), jnp.int32),
                   run_key),
        tx,
    )


def make_train_step(model: Model, tx: optim.Optimizer, emb_ops=None):
    """Returns jitted ``step(ts, batch) -> (ts, loss)``."""

    def loss_fn(params, model_state, batch, rng):
        kwargs = {} if emb_ops is None else {"emb_ops": emb_ops}
        logits, new_state = model.apply(
            params, model_state, batch, train=True, rng=rng, **kwargs
        )
        return sigmoid_ce(logits, batch["label"]), new_state

    @partial(jax.jit, donate_argnums=(0,))
    def step(ts: TrainState, batch) -> tuple[TrainState, jax.Array]:
        rng = jax.random.fold_in(ts.rng, ts.step)
        (loss, new_model_state), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(ts.params, ts.model_state, batch, rng)
        new_params, new_opt = tx.update(grads, ts.opt_state, ts.params)
        return (
            TrainState(new_params, new_model_state, new_opt, ts.step + 1,
                       ts.rng),
            loss,
        )

    return step


def make_eval_step(model: Model, emb_ops=None):
    """Returns jitted ``eval_step(params, model_state, metric_state, batch)
    -> metric_state`` — streaming-AUC update fused into the forward pass."""

    @jax.jit
    def eval_step(params, model_state, metric_state, batch):
        kwargs = {} if emb_ops is None else {"emb_ops": emb_ops}
        logits, _ = model.apply(
            params, model_state, batch, train=False, rng=None, **kwargs
        )
        return M.update_binary_metrics(metric_state, logits, batch["label"])

    return eval_step


def make_predict_step(model: Model, emb_ops=None):
    """Jitted ``predict(params, model_state, batch) -> probs`` (the PREDICT
    mode / serving signature, fm/fm.py:133-144)."""

    @jax.jit
    def predict(params, model_state, batch):
        kwargs = {} if emb_ops is None else {"emb_ops": emb_ops}
        logits, _ = model.apply(
            params, model_state, batch, train=False, rng=None, **kwargs
        )
        return jax.nn.sigmoid(logits)

    return predict
