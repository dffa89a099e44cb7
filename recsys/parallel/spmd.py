"""SPMD training: shard_map'd train step with row-sharded embedding tables.

This is the multi-chip story (SURVEY §2.3 / §5.8): a 2-D
``Mesh(('data','model'))`` where

- the batch is split over ``data`` (pure DP for the tiny dense towers);
- the packed embedding tables are row-split over ``model`` (the memory-heavy
  state — the genuine model parallelism a CTR workload needs);
- gradients all-reduce over ``data`` via an explicit ``psum`` (the NCCL
  MirroredStrategy replacement, deepfm/deepfm.py:159-169), while embedding
  lookups run the dedup + all-to-all exchange over ``model``
  (see `recsys.parallel.sharded_embedding.a2a_embedding_lookup`).

The SAME model bodies run here as in the single-chip path — only the
`EmbOps` plumbing changes — so sharded-vs-unsharded equivalence is testable
bit-for-bit (tests/test_spmd.py).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from recsys.core.mesh import DATA_AXIS, MODEL_AXIS, MeshEnv
from recsys.models.api import EmbOps, Model
from recsys.parallel import sharded_embedding as SE
from recsys.train import optim

def make_sharded_emb_ops(exact: bool = False,
                         cap_factor: float = 2.0,
                         num_model: int = 2) -> EmbOps:
    """EmbOps used *inside* shard_map: params leaves arrive pre-sharded.
    Engine-backed models route through ``engine.lookup_sharded`` (dedup +
    all-to-all); raw-table models (DIN, wide) use the psum fallbacks.

    ``num_model == 1`` returns the LOCAL ops instead: each member then
    owns the whole table, and the degenerate single-member exchange
    (sort + dedup + capacity packing + unit collectives) is pure
    overhead."""
    if num_model == 1:
        from recsys.models.api import LOCAL_EMB_OPS
        return LOCAL_EMB_OPS
    return EmbOps(
        embed=lambda p, gids: SE.psum_embedding_lookup(p["table"], gids),
        linear=lambda p, gids: SE.sharded_linear_sum(p["w"], p["b"], gids),
        sharded=True,
        a2a_exact=exact,
        a2a_cap_factor=cap_factor,
    )


#: param-subtree names that hold packed tables (models/ctr.py convention).
_TABLE_KEYS = {"embedding", "tables"}
_WIDE_KEYS = {"wide", "lin_cat"}
#: flat-stored big tables (engines.FusedGatherEngine / SplitEngine)
_FLAT_TABLE_LEAVES = {"table_flat", "big_flat"}
#: W-major [W, V_pad] tables (SplitEngine 'big_wm'): vocab rows live on
#: dim 1, so the model axis shards that dim
_WMAJOR_TABLE_LEAVES = {"big_wm", "table_wm"}


def param_specs(params) -> Any:
    """PartitionSpec tree: embedding tables row-sharded, all else replicated
    (the 'small' one-hot-matmul table of the split engine stays replicated —
    it is a few hundred KB and its lookup is a local matmul)."""

    def spec_for(path, leaf) -> P:
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in _FLAT_TABLE_LEAVES:
            return P(MODEL_AXIS)
        if keys[-1] in _WMAJOR_TABLE_LEAVES:
            return P(None, MODEL_AXIS)
        if any(k in _TABLE_KEYS for k in keys) and keys[-1] == "table":
            return P(MODEL_AXIS, None)
        if any(k in _WIDE_KEYS for k in keys) and keys[-1] == "w":
            return P(MODEL_AXIS)
        return P()

    return jax.tree_util.tree_map_with_path(spec_for, params)


def _uses_model_axis(spec: P) -> bool:
    return any(
        ax == MODEL_AXIS
        or (isinstance(ax, (tuple, list)) and MODEL_AXIS in ax)
        for ax in spec
    )


def normalize_model_replication(grads, pspecs):
    """Correct the model-axis replication factor in in-shard_map gradients.

    The per-member loss is REPLICATED over the 'model' axis (every member
    computes the same ce), so differentiating inside shard_map sums E
    identical loss copies through the lookup collectives: grads of
    model-sharded leaves come out E× too large, while replicated dense
    leaves (whose loss dependence never crosses a collective) stay 1×.
    Adam's scale invariance masks the inconsistency; FTRL/SGD would not —
    rescale sharded leaves by 1/E so every leaf carries d(loss)/d(param)
    exactly once (equivalence asserted in
    tests/test_spmd.py::test_spmd_grads_match_local_exactly).
    """
    e = jax.lax.axis_size(MODEL_AXIS)
    return jax.tree.map(
        lambda g, s: g / e if _uses_model_axis(s) else g, grads, pspecs
    )


def opt_specs(pspecs, opt_state_tmpl=None):
    """PartitionSpec tree for an optimizer state: per-param accumulators
    (mu/nu, z/n) inherit their parameter's spec, scalars replicate."""
    if opt_state_tmpl is None or isinstance(opt_state_tmpl, optim.AdamState):
        return optim.AdamState(count=P(), mu=pspecs, nu=pspecs)
    if isinstance(opt_state_tmpl, optim.FtrlState):
        return optim.FtrlState(z=pspecs, n=pspecs)
    raise TypeError(f"unknown optimizer state {type(opt_state_tmpl)}")


def batch_specs(batch) -> Any:
    return jax.tree.map(lambda v: P(DATA_AXIS, *([None] * (v.ndim - 1))),
                        batch)


def place(tree, specs, env: MeshEnv):
    """device_put a pytree with its PartitionSpec tree (global placement)."""
    return jax.tree.map(
        lambda v, s: jax.device_put(v, NamedSharding(env.mesh, s)),
        tree, specs,
    )


def place_local_batch(tree, specs, env: MeshEnv):
    """Place PROCESS-LOCAL batch arrays as global arrays.

    Single-process: plain `place`. Multi-process (jax.distributed): each
    process holds only its slice of the global batch (its file shard —
    deepfm/deepfm.py:188-194's per-process TFRecord lists are the reference
    analog), so the global array is assembled with
    ``jax.make_array_from_process_local_data``; a dim sharded over a mesh
    axis that spans P processes is P× larger globally."""
    if jax.process_count() == 1:
        return place(tree, specs, env)
    local_shape = env.mesh.local_mesh.shape

    def put(v, s):
        gshape = list(v.shape)
        for d, ax in enumerate(s):
            if ax is not None:
                span = env.mesh.shape[ax] // local_shape[ax]
                gshape[d] *= span
        return jax.make_array_from_process_local_data(
            NamedSharding(env.mesh, s), v, tuple(gshape))

    return jax.tree.map(put, tree, specs)


class SpmdState(NamedTuple):
    params: Any
    model_state: Any
    opt_state: optim.AdamState
    step: jax.Array
    rng: jax.Array


def create_spmd_state(
    model: Model, env: MeshEnv, seed: int, opt: optim.Optimizer
) -> SpmdState:
    """Init on host, then place params/opt-state with their shardings."""
    key = jax.random.key(seed)
    init_key, run_key = jax.random.split(key)
    params, model_state = model.init(init_key)
    opt_state = opt.init(params)
    pspecs = param_specs(params)
    params = place(params, pspecs, env)
    opt_state = place(opt_state, opt_specs(pspecs, opt_state), env)
    model_state = place(model_state, jax.tree.map(lambda _: P(), model_state),
                        env)
    return SpmdState(params, model_state, opt_state,
                     jnp.zeros((), jnp.int32), run_key)


def make_spmd_train_step(
    model: Model, opt: optim.Optimizer, env: MeshEnv,
    global_batch_size: int, example_batch, a2a_exact: bool = False,
    a2a_cap_factor: float = 2.0,
):
    """jitted ``step(SpmdState, batch) -> (SpmdState, loss)`` over the mesh.

    ``example_batch`` supplies the batch pytree structure for spec building
    (shapes may differ at call time as long as structure matches).
    """
    params_tmpl, mstate_tmpl = jax.eval_shape(
        lambda k: model.init(k), jax.random.key(0)
    )
    pspecs = param_specs(params_tmpl)
    ospecs = opt_specs(pspecs, jax.eval_shape(opt.init, params_tmpl))
    msspecs = jax.tree.map(lambda _: P(), mstate_tmpl)
    bspecs = batch_specs(example_batch)
    emb_ops = make_sharded_emb_ops(exact=a2a_exact, cap_factor=a2a_cap_factor,
                                   num_model=env.num_model)

    def shard_fn(params, mstate, opt_state, step, rng, batch):
        # decorrelate dropout across data shards
        local_rng = jax.random.fold_in(
            jax.random.fold_in(rng, step), jax.lax.axis_index(DATA_AXIS)
        )

        def local_loss(p, ms):
            logits, new_ms = model.apply(
                p, ms, batch, train=True, rng=local_rng,
                emb_ops=emb_ops,
            )
            labels = batch["label"].astype(jnp.float32)
            ce = jnp.sum(
                jnp.maximum(logits, 0.0) - logits * labels
                + jnp.log1p(jnp.exp(-jnp.abs(logits)))
            )
            return ce / global_batch_size, new_ms

        (loss, new_ms), grads = jax.value_and_grad(
            local_loss, has_aux=True
        )(params, mstate)
        loss = jax.lax.psum(loss, DATA_AXIS)
        grads = jax.lax.psum(grads, DATA_AXIS)
        grads = normalize_model_replication(grads, pspecs)
        new_ms = jax.lax.pmean(new_ms, DATA_AXIS)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_ms, new_opt, loss

    sharded = shard_map(
        shard_fn,
        mesh=env.mesh,
        in_specs=(pspecs, msspecs, ospecs, P(), P(), bspecs),
        out_specs=(pspecs, msspecs, ospecs, P()),
        check_vma=False,
    )

    @partial(jax.jit, donate_argnums=(0,))
    def step(st: SpmdState, batch):
        new_params, new_ms, new_opt, loss = sharded(
            st.params, st.model_state, st.opt_state, st.step, st.rng, batch
        )
        return SpmdState(new_params, new_ms, new_opt, st.step + 1, st.rng), loss

    return step


def make_spmd_train_step_scanned(
    model: Model, opt: optim.Optimizer, env: MeshEnv,
    example_stack, a2a_exact: bool = False, unroll: int = 1,
    a2a_cap_factor: float = 2.0, global_batch: int | None = None,
):
    """Scan-fused SPMD step: ``steps(SpmdState, stack[K, B, ...]) ->
    (SpmdState, mean_loss)`` — K optimizer steps per dispatch over the mesh
    (the multi-chip analog of train.fast.make_scanned_train_step).

    ``global_batch`` defaults to the example stack's batch dim; pass it
    explicitly under multi-process jax.distributed, where the example
    stack is process-local and the global batch is process_count× larger.
    """
    params_tmpl, mstate_tmpl = jax.eval_shape(
        lambda k: model.init(k), jax.random.key(0)
    )
    pspecs = param_specs(params_tmpl)
    ospecs = opt_specs(pspecs, jax.eval_shape(opt.init, params_tmpl))
    msspecs = jax.tree.map(lambda _: P(), mstate_tmpl)
    stack_specs = jax.tree.map(
        lambda v: P(None, DATA_AXIS, *([None] * (v.ndim - 2))), example_stack
    )
    if global_batch is None:
        global_batch = jax.tree.leaves(example_stack)[0].shape[1]
    emb_ops = make_sharded_emb_ops(exact=a2a_exact, cap_factor=a2a_cap_factor,
                                   num_model=env.num_model)

    def shard_fn(params, mstate, opt_state, step0, rng, stack):
        def body(carry, batch):
            params, mstate, opt_state, step = carry
            local_rng = jax.random.fold_in(
                jax.random.fold_in(rng, step), jax.lax.axis_index(DATA_AXIS)
            )

            def local_loss(p, ms):
                logits, new_ms = model.apply(
                    p, ms, batch, train=True, rng=local_rng, emb_ops=emb_ops
                )
                labels = batch["label"].astype(jnp.float32)
                ce = jnp.sum(
                    jnp.maximum(logits, 0.0) - logits * labels
                    + jnp.log1p(jnp.exp(-jnp.abs(logits)))
                )
                return ce / global_batch, new_ms

            (loss, new_ms), grads = jax.value_and_grad(
                local_loss, has_aux=True
            )(params, mstate)
            loss = jax.lax.psum(loss, DATA_AXIS)
            grads = jax.lax.psum(grads, DATA_AXIS)
            grads = normalize_model_replication(grads, pspecs)
            new_ms = jax.lax.pmean(new_ms, DATA_AXIS)
            new_params, new_opt = opt.update(grads, opt_state, params)
            return (new_params, new_ms, new_opt, step + 1), loss

        (params, mstate, opt_state, step), losses = jax.lax.scan(
            body, (params, mstate, opt_state, step0), stack, unroll=unroll
        )
        return params, mstate, opt_state, step, jnp.mean(losses)

    sharded = shard_map(
        shard_fn,
        mesh=env.mesh,
        in_specs=(pspecs, msspecs, ospecs, P(), P(), stack_specs),
        out_specs=(pspecs, msspecs, ospecs, P(), P()),
        check_vma=False,
    )

    @partial(jax.jit, donate_argnums=(0,))
    def steps(st: SpmdState, stack):
        new_params, new_ms, new_opt, step, loss = sharded(
            st.params, st.model_state, st.opt_state, st.step, st.rng, stack
        )
        return SpmdState(new_params, new_ms, new_opt, step, st.rng), loss

    return steps


def make_spmd_eval_logits(model: Model, env: MeshEnv, example_batch,
                          a2a_exact: bool = False,
                          a2a_cap_factor: float = 2.0):
    """jitted eval forward over the mesh → global logits [B]."""
    params_tmpl, mstate_tmpl = jax.eval_shape(
        lambda k: model.init(k), jax.random.key(0)
    )
    pspecs = param_specs(params_tmpl)
    msspecs = jax.tree.map(lambda _: P(), mstate_tmpl)
    bspecs = batch_specs(example_batch)
    emb_ops = make_sharded_emb_ops(exact=a2a_exact, cap_factor=a2a_cap_factor,
                                   num_model=env.num_model)

    def shard_fn(params, mstate, batch):
        logits, _ = model.apply(
            params, mstate, batch, train=False, rng=None,
            emb_ops=emb_ops,
        )
        return logits

    sharded = shard_map(
        shard_fn, mesh=env.mesh,
        in_specs=(pspecs, msspecs, bspecs),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return jax.jit(sharded)
