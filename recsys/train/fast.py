"""Fast training path: device-resident dataset + scan-fused steps.

The reference streams 256-example batches through a host feed
(fm/fm.py:106-112) and tops out at ~12 steps/s; on an accelerator the
per-step dispatch and H2D copies dominate long before the device does.
This module removes both:

- the (preprocessed, fixed-shape) dataset lives in HBM as one array per
  feature; per-step batches are device-side gathers — no host↔device
  traffic in the steady state;
- K optimizer steps fuse into ONE XLA program via ``lax.scan`` over a
  [K, B] index matrix, so Python dispatch cost is amortized K× and XLA can
  pipeline the gather of step k+1 against the backward of step k;
- epoch shuffling is a host-side permutation of *indices* (cheap), not of
  the data.

Falls back automatically (see tools/train_ctr.py) to the streaming
`ShardSource` + `device_prefetch` pipeline when the dataset exceeds the HBM
budget — same model/step semantics either way.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from recsys.models.api import Model
from recsys.train import metrics as M
from recsys.train.train_state import TrainState, sigmoid_ce


def stage_dataset(data: dict[str, np.ndarray], sharding=None) -> dict:
    """Host arrays → device arrays (optionally sharded over 'data')."""
    put = (lambda v: jax.device_put(v, sharding)) if sharding is not None \
        else jnp.asarray
    return {k: put(v) for k, v in data.items()}


def epoch_index_matrix(n_rows: int, batch_size: int, steps: int, rng) -> np.ndarray:
    """[steps, batch] random row indices (with-replacement shuffling keeps
    every step shape-static and is statistically equivalent at this scale)."""
    return rng.integers(0, n_rows, size=(steps, batch_size)).astype(np.int32)


def _make_batch_step(model: Model, tx):
    """One optimizer step on an in-hand batch: ``step(ts, batch) -> (ts, loss)``."""

    def loss_fn(params, model_state, batch, rng):
        logits, new_state = model.apply(
            params, model_state, batch, train=True, rng=rng
        )
        return sigmoid_ce(logits, batch["label"]), new_state

    def step(ts: TrainState, batch):
        rng = jax.random.fold_in(ts.rng, ts.step)
        (loss, new_ms), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(ts.params, ts.model_state, batch, rng)
        new_params, new_opt = tx.update(grads, ts.opt_state, ts.params)
        return (
            TrainState(new_params, new_ms, new_opt, ts.step + 1, ts.rng),
            loss,
        )

    return step


def _make_step_body(model: Model, tx):
    """Shared scan body: one optimizer step on a device-side gathered batch."""
    step = _make_batch_step(model, tx)

    def body(ts: TrainState, data, idx):
        batch = {k: jnp.take(v, idx, axis=0) for k, v in data.items()}
        return step(ts, batch)

    return body


def make_scanned_train_step(model: Model, tx, unroll: int = 1):
    """jitted ``steps(ts, data, idx[K,B]) -> (ts, mean_loss)`` — K fused
    optimizer steps per dispatch, batch indices supplied by the host
    (deterministic; used by tests and the epoch-exact training path)."""
    body = _make_step_body(model, tx)

    @partial(jax.jit, donate_argnums=(0,))
    def steps(ts: TrainState, data, idx_matrix):
        ts, losses = jax.lax.scan(
            lambda c, i: body(c, data, i), ts, idx_matrix, unroll=unroll
        )
        return ts, jnp.mean(losses)

    return steps


def make_scanned_train_step_devgen(
    model: Model, tx, n_rows: int, batch_size: int, unroll: int = 1
):
    """jitted ``steps(ts, data, k) -> (ts, mean_loss)`` with batch indices
    generated ON DEVICE (with-replacement, `jax.random.randint` folded from
    the train-state PRNG) — zero host→device traffic in the steady state.

    Unlike the idx-matrix variant, nothing crosses the host↔device
    boundary per call; sampling semantics match ``epoch_index_matrix``
    (with-replacement shuffling, statistically equivalent at scale)."""
    body = _make_step_body(model, tx)

    @partial(jax.jit, static_argnums=(2,), donate_argnums=(0,))
    def steps(ts: TrainState, data, k: int):
        def scan_body(ts, _):
            # dedicated index stream: fold a constant tag first so the key
            # can never collide with the model/dropout key fold_in(rng, step)
            ikey = jax.random.fold_in(
                jax.random.fold_in(ts.rng, 0x1D8), ts.step)
            idx = jax.random.randint(ikey, (batch_size,), 0, n_rows,
                                     dtype=jnp.int32)
            return body(ts, data, idx)

        ts, losses = jax.lax.scan(scan_body, ts, None, length=k,
                                  unroll=unroll)
        return ts, jnp.mean(losses)

    return steps


def make_scanned_train_step_sampler(
    model: Model, tx, sample_fn, batch_size: int, unroll: int = 1
):
    """jitted ``steps(ts, tables, k) -> (ts, mean_loss)`` where every scan
    iteration draws a FRESH batch from ``sample_fn(key, tables, batch_size)``
    on device (data/synthetic_device.make_device_sampler) — true one-pass
    online SGD on the population distribution. No dataset in HBM, no
    host→device traffic; generation fuses into the same XLA program as the
    step, so XLA pipelines sampling of step k+1 against the backward of k."""
    step = _make_batch_step(model, tx)

    @partial(jax.jit, static_argnums=(2,), donate_argnums=(0,))
    def steps(ts: TrainState, tables, k: int):
        def scan_body(ts, _):
            # dedicated sample-stream tag, disjoint from the model/dropout
            # key fold_in(rng, step) and the index stream (0x1D8)
            skey = jax.random.fold_in(
                jax.random.fold_in(ts.rng, 0x5A17), ts.step)
            batch = sample_fn(skey, tables, batch_size)
            return step(ts, batch)

        ts, losses = jax.lax.scan(scan_body, ts, None, length=k,
                                  unroll=unroll)
        return ts, jnp.mean(losses)

    return steps


def make_scanned_eval(model: Model):
    """jitted streaming-metric eval over a [K, B] index matrix in one
    dispatch."""

    @jax.jit
    def eval_steps(params, model_state, data, idx_matrix, metric_state):
        def body(mstate, idx):
            batch = {k: jnp.take(v, idx, axis=0) for k, v in data.items()}
            logits, _ = model.apply(params, model_state, batch, train=False,
                                    rng=None)
            return M.update_binary_metrics(mstate, logits, batch["label"]), 0
        mstate, _ = jax.lax.scan(body, metric_state, idx_matrix)
        return mstate

    return eval_steps


def train_on_device(
    model: Model,
    tx,
    ts: TrainState,
    data: dict[str, np.ndarray],
    *,
    batch_size: int,
    num_steps: int,
    steps_per_call: int = 50,
    seed: int = 0,
    log_every_calls: int = 5,
    log_fn=None,
):
    """Drive ``num_steps`` with the fused path (device-generated batch
    indices — the same path `loop.train_and_evaluate_fast` and bench.py
    run). Returns (ts, last_loss)."""
    import time

    staged = stage_dataset(data)
    n = len(next(iter(data.values())))
    step_fn = make_scanned_train_step_devgen(model, tx, n, batch_size)
    done = 0
    loss = None
    t0 = time.perf_counter()
    calls = 0
    while done < num_steps:
        k = min(steps_per_call, num_steps - done)
        ts, loss = step_fn(ts, staged, k)
        done += k
        calls += 1
        if log_fn is not None and calls % log_every_calls == 0:
            jax.block_until_ready(loss)
            dt = time.perf_counter() - t0
            log_fn(done, float(loss), done * batch_size / dt)
    jax.block_until_ready(loss)
    return ts, float(loss) if loss is not None else float("nan")
