"""train_and_evaluate driver.

Replaces ``tf.estimator.train_and_evaluate`` + RunConfig cadence
(deepfm/deepfm.py:159-210 and clones): periodic eval with streaming AUC,
periodic + best-metric checkpointing, step-rate logging (the reference's
``global_step/sec``), and resume-from-latest on restart (the estimator's
implicit fault-tolerance, SURVEY §5.3-5.4).
"""

from __future__ import annotations

import logging
import time
from typing import Iterable, Iterator

import jax
import numpy as np

from recsys.core.checkpoint import CheckpointManager
from recsys.core.config import TrainConfig
from recsys.models.api import Model
from recsys.train import metrics as M
from recsys.train import train_state as TS
from recsys.train.summaries import ScalarWriter

log = logging.getLogger("recsys")


def evaluate(
    model: Model,
    params,
    model_state,
    eval_batches: Iterable[dict],
    max_steps: int | None = None,
    emb_ops=None,
) -> dict[str, float]:
    """One eval sweep → {'auc', 'accuracy', 'logloss', 'count'}."""
    eval_step = TS.make_eval_step(model, emb_ops)
    mstate = M.init_binary_metrics()
    for i, batch in enumerate(eval_batches):
        if max_steps is not None and i >= max_steps:
            break
        mstate = eval_step(params, model_state, mstate, batch)
    return M.finalize_binary_metrics(mstate)


def train_and_evaluate(
    model: Model,
    train_iter: Iterator[dict],
    eval_batches_fn,
    cfg: TrainConfig,
    *,
    num_steps: int,
    emb_ops=None,
    resume: bool = True,
) -> dict[str, float]:
    """Train for ``num_steps`` with periodic eval + checkpointing.

    ``eval_batches_fn()`` returns a fresh finite iterable of eval batches
    (the EvalSpec input_fn analog). Returns the final eval metrics.
    """
    ts, tx = TS.create_train_state(model, cfg.seed, cfg.learning_rate)
    step_fn = TS.make_train_step(model, tx, emb_ops)
    ckpt = CheckpointManager(cfg.model_dir, cfg.keep_checkpoint_max)

    start_step = 0
    if resume:
        restored = ckpt.restore((ts.params, ts.model_state, ts.opt_state))
        if restored is not None:
            (params, model_state, opt_state), start_step, _ = restored
            ts = ts._replace(
                params=jax.tree.map(jax.numpy.asarray, params),
                model_state=jax.tree.map(jax.numpy.asarray, model_state),
                opt_state=jax.tree.map(jax.numpy.asarray, opt_state),
                step=jax.numpy.asarray(start_step, jax.numpy.int32),
            )
            log.info("resumed from step %d", start_step)

    t0 = time.time()
    window_t0, window_step = t0, start_step
    losses: list[float] = []
    last_metrics: dict[str, float] = {}
    writer = ScalarWriter(cfg.model_dir)

    for step_idx in range(start_step, num_steps):
        batch = next(train_iter)
        ts, loss = step_fn(ts, batch)

        if (step_idx + 1) % cfg.log_every_steps == 0:
            loss_v = float(loss)
            losses.append(loss_v)
            now = time.time()
            rate = (step_idx + 1 - window_step) / max(now - window_t0, 1e-9)
            bsz = len(np.asarray(batch["label"]))
            log.info(
                "step %d loss %.5f  %.1f steps/s  %.0f ex/s",
                step_idx + 1, loss_v, rate, rate * bsz,
            )
            writer.write(step_idx + 1, loss=loss_v,
                         examples_per_sec=rate * bsz)
            window_t0, window_step = now, step_idx + 1

        do_eval = (step_idx + 1) % cfg.eval_every_steps == 0
        do_ckpt = (step_idx + 1) % cfg.save_checkpoints_steps == 0
        if do_eval or step_idx + 1 == num_steps:
            last_metrics = evaluate(
                model, ts.params, ts.model_state, eval_batches_fn(),
                max_steps=cfg.eval_steps, emb_ops=emb_ops,
            )
            log.info(
                "eval @ step %d: auc %.5f logloss %.5f acc %.5f",
                step_idx + 1, last_metrics["auc"], last_metrics["logloss"],
                last_metrics["accuracy"],
            )
            writer.write(step_idx + 1, eval_auc=last_metrics["auc"],
                         eval_logloss=last_metrics["logloss"])
            do_ckpt = True
        if do_ckpt:
            ckpt.save(
                step_idx + 1,
                (ts.params, ts.model_state, ts.opt_state),
                metric=last_metrics.get("auc"),
            )

    writer.close()
    last_metrics["train_seconds"] = time.time() - t0
    last_metrics["final_loss"] = losses[-1] if losses else float("nan")
    return last_metrics


def train_and_evaluate_fast(
    model: Model,
    train_data: dict[str, np.ndarray],
    eval_data: dict[str, np.ndarray],
    cfg: TrainConfig,
    *,
    num_steps: int,
    steps_per_call: int = 50,
    resume: bool = True,
) -> dict[str, float]:
    """Fast-path driver: whole dataset in HBM, scan-fused steps
    (recsys.train.fast), periodic eval + checkpointing as in
    `train_and_evaluate`. Use when the preprocessed dataset fits on chip."""
    import jax.numpy as jnp

    from recsys.train import fast

    ts, tx = TS.create_train_state(model, cfg.seed, cfg.learning_rate)
    ckpt = CheckpointManager(cfg.model_dir, cfg.keep_checkpoint_max)
    start_step = 0
    if resume:
        restored = ckpt.restore((ts.params, ts.model_state, ts.opt_state))
        if restored is not None:
            (params, model_state, opt_state), start_step, _ = restored
            ts = ts._replace(
                params=jax.tree.map(jnp.asarray, params),
                model_state=jax.tree.map(jnp.asarray, model_state),
                opt_state=jax.tree.map(jnp.asarray, opt_state),
                step=jnp.asarray(start_step, jnp.int32),
            )
            log.info("resumed from step %d", start_step)

    staged_train = fast.stage_dataset(train_data)
    staged_eval = fast.stage_dataset(eval_data)
    n_train = len(train_data["label"])
    n_eval = len(eval_data["label"])
    # device-generated batch indices: zero host→device bytes in steady state
    step_fn = fast.make_scanned_train_step_devgen(model, tx, n_train,
                                                  cfg.batch_size)
    eval_fn = fast.make_scanned_eval(model)

    def run_eval():
        bs = min(cfg.batch_size, n_eval)
        # sequential coverage of the eval set, truncated (never wrapped —
        # wrapping would double-count examples in the streaming metrics)
        n_batches = min(cfg.eval_steps, max(1, n_eval // bs))
        idx = np.arange(n_batches * bs).reshape(n_batches, bs)
        mstate = eval_fn(ts.params, ts.model_state, staged_eval,
                         jnp.asarray(idx, jnp.int32),
                         M.init_binary_metrics())
        return M.finalize_binary_metrics(mstate)

    t0 = time.time()
    window_t0, window_steps = t0, start_step
    done = start_step
    last_metrics: dict[str, float] = {}
    loss_v = float("nan")
    writer = ScalarWriter(cfg.model_dir)
    next_eval = ((done // cfg.eval_every_steps) + 1) * cfg.eval_every_steps
    while done < num_steps:
        k = min(steps_per_call, num_steps - done, max(1, next_eval - done))
        ts, loss = step_fn(ts, staged_train, k)
        done += k
        if done >= next_eval or done >= num_steps:
            loss_v = float(loss)
            now = time.time()
            rate = (done - window_steps) / max(now - window_t0, 1e-9)
            log.info("step %d loss %.5f  %.1f steps/s  %.0f ex/s",
                     done, loss_v, rate, rate * cfg.batch_size)
            window_t0, window_steps = now, done
            last_metrics = run_eval()
            log.info("eval @ step %d: auc %.5f logloss %.5f acc %.5f",
                     done, last_metrics["auc"], last_metrics["logloss"],
                     last_metrics["accuracy"])
            writer.write(done, loss=loss_v,
                         examples_per_sec=rate * cfg.batch_size,
                         eval_auc=last_metrics["auc"],
                         eval_logloss=last_metrics["logloss"])
            ckpt.save(done, (ts.params, ts.model_state, ts.opt_state),
                      metric=last_metrics.get("auc"))
            next_eval += cfg.eval_every_steps

    writer.close()
    last_metrics["train_seconds"] = time.time() - t0
    last_metrics["final_loss"] = loss_v
    return last_metrics
