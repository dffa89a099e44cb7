"""Model API: a model is (init, apply) pure functions bound to a config.

Replaces the reference's estimator ``model_fn(features, labels, mode,
params)`` convention (fm/fm.py:115, deepfm/deepfm.py:73, ...) with an
explicitly functional contract:

    model = make_model(name, criteo_cfg, model_cfg)
    params, state = model.init(rng)
    logits, new_state = model.apply(params, state, batch, train=..., rng=...)

- ``params``: trainable pytree (embedding tables + dense towers).
- ``state``:  non-trainable pytree (batch-norm moving stats).
- ``batch``:  {'ids': int32 [B, F] field-local ids,
               'dense': float32 [B, 13] log-scaled continuous values,
               'label': float32 [B]} for Criteo models.
- ``logits``: float32 [B].

Embedding access goes through an ``EmbOps`` so the same model body runs with
replicated tables (default) or row-sharded tables inside `shard_map`
(recsys.parallel.spmd).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import jax

from recsys.embeddings import table as emb_table


@dataclass(frozen=True)
class EmbOps:
    """Pluggable embedding access: local (replicated) or sharded.

    ``sharded=True`` tells engine-backed models (the CTR zoo) to route table
    access through ``engine.lookup_sharded`` — the dedup + all-to-all path
    over the 'model' mesh axis (recsys.parallel.sharded_embedding); the
    ``embed``/``linear`` callables serve models that own raw tables (DIN,
    wide). ``a2a_exact`` sizes the all-to-all capacity for the worst case
    (lossless; used by equivalence tests); ``a2a_cap_factor`` sizes the
    non-exact capacity (ids beyond it would silently drop). The SPMD
    driver checks the factor against SAMPLED batches at startup and — for
    streams — periodically during training (train/spmd_loop.py
    resolve_a2a_exact / _recheck_stacks), which catches skewed id→owner
    distributions with high probability but is not a worst-case
    guarantee; only ``a2a_exact=True`` is lossless by construction.
    """

    embed: Callable[[dict, jax.Array], jax.Array]
    linear: Callable[[dict, jax.Array], jax.Array]
    sharded: bool = False
    a2a_exact: bool = False
    a2a_cap_factor: float = 2.0


LOCAL_EMB_OPS = EmbOps(
    embed=lambda p, gids: emb_table.embedding_lookup(p, gids),
    linear=lambda p, gids: emb_table.linear_sum(p, gids),
)


@dataclass(frozen=True)
class Model:
    name: str
    init: Callable[[jax.Array], tuple[Any, Any]]
    apply: Callable[..., tuple[jax.Array, Any]]
    #: static facts other subsystems need (e.g. ``emb_width`` = D+1, used by
    #: the SPMD path to view flat-stored tables as [rows, width]).
    meta: dict = field(default_factory=dict)


_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def make_model(name: str, *args, **kwargs) -> Model:
    if name not in _REGISTRY:
        # Import model modules lazily so registration happens on demand.
        import recsys.models.ctr  # noqa: F401
        import recsys.models.din  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](*args, **kwargs)


def available_models() -> list[str]:
    import recsys.models.ctr  # noqa: F401
    import recsys.models.din  # noqa: F401
    return sorted(_REGISTRY)
