"""Multi-chip train_and_evaluate driver (the SPMD product path).

The reference's default training mode is estimator ``train_and_evaluate``
UNDER distribution (``MirroredStrategy`` applied to both train and eval,
deepfm/deepfm.py:159-210); this is its mesh-parallel equivalent: the batch
is split over the 'data' axis, embedding tables row-shard over 'model'
(dedup + all-to-all lookup), the scan-fused SPMD step fuses K optimizer
steps per dispatch, eval streams the same AUC/logloss metrics, and
checkpoints + JSONL scalars land in ``model_dir`` exactly like the
single-chip drivers — resume included.

Reachable from the CLI: ``python -m recsys.tools.train_ctr train
--mesh.model_axis=2 ...`` (tools/train_ctr.py picks this driver whenever
the mesh spans more than one device).
"""

from __future__ import annotations

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np

from recsys.core.checkpoint import CheckpointManager
from recsys.core.config import MeshConfig, TrainConfig
from recsys.core.mesh import DATA_AXIS, MeshEnv, make_mesh
from recsys.models.api import Model
from recsys.parallel import spmd
from recsys.train import metrics as M
from recsys.train import optim
from recsys.train.summaries import ScalarWriter

log = logging.getLogger("recsys")


def _stack_batches(data: dict[str, np.ndarray], idx: np.ndarray) -> dict:
    """[K, B] row indices → stacked host batch pytree [K, B, ...]."""
    return {k: v[idx] for k, v in data.items()}


def resolve_a2a_exact(
    model: Model,
    mesh_cfg: MeshConfig,
    env: MeshEnv,
    sample_ids: list[np.ndarray],
) -> bool:
    """Startup capacity check for the non-exact a2a embedding exchange.

    The dedup+all-to-all lookup sizes its per-owner wire capacity by
    ``mesh_cfg.a2a_cap_factor``; unique ids beyond it would read as zero
    rows AND drop their gradients (parallel/sharded_embedding.py — only
    reachable when the id→owner distribution is skewed beyond the factor).
    That must never happen silently: before compiling the sharded step the
    driver measures the overflow that THIS id distribution would produce
    (``engine.a2a_overflow`` over sampled batches) and applies
    ``mesh_cfg.a2a_policy``:

    - 'check' (default): overflow > 0 → raise with guidance;
    - 'auto':            overflow > 0 → upgrade the run to exact capacity
                         (lossless, larger collectives) with a warning;
    - 'off':             trust the factor, skip the measurement.

    Returns the effective ``a2a_exact`` flag for the run.
    """
    if mesh_cfg.a2a_exact or env.num_model <= 1:
        return mesh_cfg.a2a_exact
    if mesh_cfg.a2a_policy == "off":
        return False
    engine = model.meta.get("engine")
    if engine is None or not hasattr(engine, "a2a_overflow"):
        return False   # model has no a2a path (psum fallback models)
    worst = max(
        engine.a2a_overflow(ids, env.num_data, env.num_model,
                            mesh_cfg.a2a_cap_factor)
        for ids in sample_ids
    )
    if worst == 0:
        log.info(
            "a2a capacity check: cap_factor=%.2f lossless for %d sampled "
            "batches (mesh %dx%d)", mesh_cfg.a2a_cap_factor,
            len(sample_ids), env.num_data, env.num_model)
        return False
    if mesh_cfg.a2a_policy == "auto":
        log.warning(
            "a2a capacity check: %d unique ids/batch would overflow "
            "cap_factor=%.2f — upgrading this run to a2a_exact=True "
            "(lossless, larger collectives)", worst,
            mesh_cfg.a2a_cap_factor)
        return True
    raise ValueError(
        f"sharded-embedding a2a overflow: {worst} unique ids of a sampled "
        f"batch exceed the per-owner capacity at "
        f"a2a_cap_factor={mesh_cfg.a2a_cap_factor} on a "
        f"{env.num_data}x{env.num_model} mesh — activations and gradients "
        "for those ids would be silently dropped. Fix: raise "
        "--mesh.a2a_cap_factor, set --mesh.a2a_exact=true (lossless), or "
        "set --mesh.a2a_policy=auto to upgrade automatically.")


def train_and_evaluate_spmd(
    model: Model,
    train_data: dict[str, np.ndarray],
    eval_data: dict[str, np.ndarray],
    cfg: TrainConfig,
    mesh_cfg: MeshConfig = MeshConfig(),
    *,
    num_steps: int,
    steps_per_call: int = 10,
    env: MeshEnv | None = None,
    resume: bool = True,
    a2a_exact: bool | None = None,
) -> dict[str, float]:
    """Train over the ('data','model') mesh with periodic eval + ckpt.

    Semantics match `loop.train_and_evaluate_fast` (with-replacement batch
    sampling, streaming eval metrics, keep-k + best-AUC checkpoints); only
    the placement differs: batches shard over 'data', tables over 'model'.

    ``a2a_exact=None`` (default) resolves from ``mesh_cfg`` via the startup
    capacity check (`resolve_a2a_exact`).
    """
    env = env if env is not None else make_mesh(mesh_cfg)
    if a2a_exact is None:
        check_rng = np.random.default_rng([cfg.seed, 0xA2A])
        n_rows = len(train_data["label"])
        sample_ids = [
            train_data["ids"][check_rng.integers(0, n_rows, cfg.batch_size)]
            for _ in range(4)
        ]
        a2a_exact = resolve_a2a_exact(model, mesh_cfg, env, sample_ids)
    opt = optim.for_model(model.meta, cfg.learning_rate)
    ckpt = CheckpointManager(cfg.model_dir, cfg.keep_checkpoint_max)

    init_key, run_key = jax.random.split(jax.random.key(cfg.seed))
    params, mstate = model.init(init_key)
    opt_state = opt.init(params)
    start_step = 0
    if resume:
        restored = ckpt.restore((params, mstate, opt_state))
        if restored is not None:
            (params, mstate, opt_state), start_step, _ = restored
            log.info("resumed from step %d", start_step)

    pspecs = spmd.param_specs(params)
    state = spmd.SpmdState(
        params=spmd.place(params, pspecs, env),
        model_state=spmd.place(
            mstate, jax.tree.map(lambda _: spmd.P(), mstate), env),
        opt_state=spmd.place(opt_state, spmd.opt_specs(pspecs, opt_state),
                             env),
        step=jnp.asarray(start_step, jnp.int32),
        rng=run_key,
    )

    n_train = len(train_data["label"])
    n_eval = len(eval_data["label"])
    bs = cfg.batch_size
    if bs % env.num_data != 0:
        raise ValueError(
            f"batch_size {bs} not divisible by data axis {env.num_data}")

    rng = np.random.default_rng(cfg.seed)
    example_idx = rng.integers(0, n_train, size=(steps_per_call, bs))
    example_stack = _stack_batches(train_data, example_idx)
    step_fn = spmd.make_spmd_train_step_scanned(
        model, opt, env, example_stack, a2a_exact=a2a_exact,
        a2a_cap_factor=mesh_cfg.a2a_cap_factor)

    eval_bs = min(bs, n_eval)
    eval_example = {k: v[:eval_bs] for k, v in eval_data.items()}
    eval_logits_fn = spmd.make_spmd_eval_logits(
        model, env, eval_example, a2a_exact=a2a_exact,
        a2a_cap_factor=mesh_cfg.a2a_cap_factor)
    metric_update = jax.jit(M.update_binary_metrics)

    def run_eval(st: spmd.SpmdState) -> dict[str, float]:
        n_batches = min(cfg.eval_steps, max(1, n_eval // eval_bs))
        mstate_m = M.init_binary_metrics()
        for i in range(n_batches):
            hb = {k: v[i * eval_bs:(i + 1) * eval_bs] for k, v in
                  eval_data.items()}
            batch = spmd.place(hb, spmd.batch_specs(hb), env)
            logits = eval_logits_fn(st.params, st.model_state, batch)
            mstate_m = metric_update(mstate_m, logits, batch["label"])
        return M.finalize_binary_metrics(mstate_m)

    writer = ScalarWriter(cfg.model_dir)
    t0 = time.time()
    window_t0, window_steps = t0, start_step
    done = start_step
    last_metrics: dict[str, float] = {}
    loss_v = float("nan")
    next_eval = ((done // cfg.eval_every_steps) + 1) * cfg.eval_every_steps
    stack_specs = jax.tree.map(
        lambda v: spmd.P(None, DATA_AXIS, *([None] * (v.ndim - 2))),
        example_stack)
    while done < num_steps:
        k = min(steps_per_call, num_steps - done, max(1, next_eval - done))
        idx = rng.integers(0, n_train, size=(k, bs))
        stack = spmd.place(_stack_batches(train_data, idx), stack_specs, env)
        state, loss = step_fn(state, stack)
        done += k
        if done >= next_eval or done >= num_steps:
            loss_v = float(loss)
            now = time.time()
            rate = (done - window_steps) / max(now - window_t0, 1e-9)
            log.info("spmd step %d loss %.5f  %.1f steps/s  %.0f ex/s "
                     "(mesh %dx%d)", done, loss_v, rate, rate * bs,
                     env.num_data, env.num_model)
            window_t0, window_steps = now, done
            last_metrics = run_eval(state)
            log.info("eval @ step %d: auc %.5f logloss %.5f acc %.5f",
                     done, last_metrics["auc"], last_metrics["logloss"],
                     last_metrics["accuracy"])
            writer.write(done, loss=loss_v, examples_per_sec=rate * bs,
                         eval_auc=last_metrics["auc"],
                         eval_logloss=last_metrics["logloss"])
            ckpt.save(
                done,
                (jax.device_get(state.params),
                 jax.device_get(state.model_state),
                 jax.device_get(state.opt_state)),
                metric=last_metrics.get("auc"),
            )
            next_eval += cfg.eval_every_steps
    writer.close()

    last_metrics["train_seconds"] = time.time() - t0
    last_metrics["final_loss"] = loss_v
    return last_metrics


def _stack_iter(host_iter, k: int):
    """Group a stream of [B] host batches into [K, B, ...] scan stacks.
    A trailing partial group (fewer than K batches left in the epoch
    stream) is dropped — scan stacks must be shape-static."""
    while True:
        group = []
        for _ in range(k):
            try:
                group.append(next(host_iter))
            except StopIteration:
                if group:
                    log.info("dropping trailing partial stack of %d batches",
                             len(group))
                return
        yield {key: np.stack([g[key] for g in group])
               for key in group[0]}


def train_and_evaluate_spmd_stream(
    model: Model,
    train_batches,
    eval_batches_fn,
    cfg: TrainConfig,
    mesh_cfg: MeshConfig = MeshConfig(),
    *,
    num_steps: int,
    steps_per_call: int = 10,
    env: MeshEnv | None = None,
    resume: bool = True,
    prefetch_depth: int = 2,
) -> dict[str, float]:
    """Streaming multi-chip driver: ShardSource → stack → device_prefetch.

    Unlike `train_and_evaluate_spmd` (which holds the dataset in host RAM
    and samples with replacement), this consumes a host batch ITERATOR with
    real epoch semantics — `data.loader.ShardSource` (epoch shuffle, carry
    buffer, per-host shard assignment) feeds [K, B] scan stacks that a
    background thread stages onto the mesh (`device_prefetch` with the
    [None, 'data'] stack sharding) while the previous fused dispatch runs.
    Nothing larger than ``prefetch_depth`` stacks is ever resident on the
    host side of the pipeline. Reference analog: the per-process TFRecord
    file lists + prefetch of deepfm/deepfm.py:188-202.
    """
    from recsys.data.loader import device_prefetch

    env = env if env is not None else make_mesh(mesh_cfg)
    opt = optim.for_model(model.meta, cfg.learning_rate)
    ckpt = CheckpointManager(cfg.model_dir, cfg.keep_checkpoint_max)

    init_key, run_key = jax.random.split(jax.random.key(cfg.seed))
    params, mstate = model.init(init_key)
    opt_state = opt.init(params)
    start_step = 0
    if resume:
        restored = ckpt.restore((params, mstate, opt_state))
        if restored is not None:
            (params, mstate, opt_state), start_step, _ = restored
            log.info("resumed from step %d (stream restarts at epoch head)",
                     start_step)

    pspecs = spmd.param_specs(params)
    state = spmd.SpmdState(
        params=spmd.place(params, pspecs, env),
        model_state=spmd.place(
            mstate, jax.tree.map(lambda _: spmd.P(), mstate), env),
        opt_state=spmd.place(opt_state, spmd.opt_specs(pspecs, opt_state),
                             env),
        step=jnp.asarray(start_step, jnp.int32),
        rng=run_key,
    )

    host_iter = iter(train_batches)
    stack_iter = _stack_iter(host_iter, steps_per_call)
    try:
        first_stack = next(stack_iter)
    except StopIteration:
        raise ValueError("train stream yielded no full scan stack") from None
    bs = len(first_stack["label"][0])
    # under multi-process jax.distributed each process streams its own file
    # shard: the stream's batches are process-local slices of a
    # process_count×-larger global batch
    data_span = (env.mesh.shape[DATA_AXIS]
                 // env.mesh.local_mesh.shape[DATA_AXIS])
    global_bs = bs * data_span
    if global_bs % env.num_data != 0:
        raise ValueError(
            f"global batch {global_bs} not divisible by data axis "
            f"{env.num_data}")

    a2a_exact = resolve_a2a_exact(
        model, mesh_cfg, env,
        [first_stack["ids"][i] for i in range(min(4, steps_per_call))])

    def _recheck_stacks(stacks, period: int = 64):
        """The startup check only sees the epoch head; a non-stationary or
        unshuffled stream can drift to heavier id→owner skew later. Recheck
        one batch of every ``period``-th stack (cheap host numpy) so a
        would-be silent overflow fails loudly instead."""
        engine = model.meta.get("engine")
        check = (not a2a_exact and env.num_model > 1
                 and mesh_cfg.a2a_policy != "off"
                 and engine is not None and hasattr(engine, "a2a_overflow"))
        for n, stack in enumerate(stacks):
            if check and n % period == 0 and n > 0:
                worst = engine.a2a_overflow(
                    stack["ids"][0], env.num_data, env.num_model,
                    mesh_cfg.a2a_cap_factor)
                if worst:
                    raise ValueError(
                        f"sharded-embedding a2a overflow mid-stream (stack "
                        f"{n}): {worst} unique ids exceed the per-owner "
                        f"capacity at a2a_cap_factor="
                        f"{mesh_cfg.a2a_cap_factor} — the stream's id "
                        "distribution drifted beyond the startup sample. "
                        "Fix: raise --mesh.a2a_cap_factor or set "
                        "--mesh.a2a_exact=true (lossless).")
            yield stack

    example_stack = {k: v for k, v in first_stack.items()}
    step_fn = spmd.make_spmd_train_step_scanned(
        model, opt, env, example_stack, a2a_exact=a2a_exact,
        a2a_cap_factor=mesh_cfg.a2a_cap_factor, global_batch=global_bs)

    eval_logits_fn = None
    metric_update = jax.jit(M.update_binary_metrics)

    def run_eval(st: spmd.SpmdState) -> dict[str, float]:
        nonlocal eval_logits_fn
        mstate_m = M.init_binary_metrics()
        n_done = n_skipped = 0
        for hb in eval_batches_fn():
            if len(hb["label"]) != bs:
                n_skipped += 1   # static shapes: skip stragglers
                continue
            batch = spmd.place_local_batch(hb, spmd.batch_specs(hb), env)
            if eval_logits_fn is None:
                eval_logits_fn = spmd.make_spmd_eval_logits(
                    model, env, batch, a2a_exact=a2a_exact,
                    a2a_cap_factor=mesh_cfg.a2a_cap_factor)
            logits = eval_logits_fn(st.params, st.model_state, batch)
            mstate_m = metric_update(mstate_m, logits, batch["label"])
            n_done += 1
            if n_done >= cfg.eval_steps:
                break
        if n_done == 0:
            raise ValueError(
                f"eval stream produced no batch of the train batch size "
                f"{bs} ({n_skipped} other-sized batches skipped) — metrics "
                "would finalize over zero updates. Make eval_batches_fn "
                "yield the train batch size (stragglers are dropped).")
        if n_skipped:
            log.info("eval: %d straggler batches skipped (size != %d)",
                     n_skipped, bs)
        return M.finalize_binary_metrics(mstate_m)

    # chain the first stack back in front of the prefetched stream
    import itertools
    stacked = _recheck_stacks(itertools.chain([first_stack], stack_iter))
    dev_iter = device_prefetch(
        stacked, env, depth=prefetch_depth,
        axes_fn=lambda v: [None, "data"] + [None] * (v.ndim - 2))

    writer = ScalarWriter(cfg.model_dir)
    t0 = time.time()
    window_t0, window_steps = t0, start_step
    done = start_step
    last_metrics: dict[str, float] = {}
    loss_v = float("nan")
    next_eval = ((done // cfg.eval_every_steps) + 1) * cfg.eval_every_steps
    for stack in dev_iter:
        if done >= num_steps:
            break
        state, loss = step_fn(state, stack)
        done += steps_per_call
        if done >= next_eval or done >= num_steps:
            loss_v = float(loss)
            now = time.time()
            rate = (done - window_steps) / max(now - window_t0, 1e-9)
            log.info("spmd-stream step %d loss %.5f  %.1f steps/s  %.0f ex/s"
                     " (mesh %dx%d)", done, loss_v, rate, rate * global_bs,
                     env.num_data, env.num_model)
            window_t0, window_steps = now, done
            last_metrics = run_eval(state)
            log.info("eval @ step %d: auc %.5f logloss %.5f acc %.5f",
                     done, last_metrics["auc"], last_metrics["logloss"],
                     last_metrics["accuracy"])
            writer.write(done, loss=loss_v, examples_per_sec=rate * global_bs,
                         eval_auc=last_metrics["auc"],
                         eval_logloss=last_metrics["logloss"])
            ckpt.save(
                done,
                (jax.device_get(state.params),
                 jax.device_get(state.model_state),
                 jax.device_get(state.opt_state)),
                metric=last_metrics.get("auc"),
            )
            next_eval += cfg.eval_every_steps
    writer.close()

    if not last_metrics:
        last_metrics = run_eval(state)
    last_metrics["train_seconds"] = time.time() - t0
    last_metrics["final_loss"] = loss_v
    last_metrics["steps_done"] = done
    return last_metrics
