"""Unified offset-packed embedding tables.

Replacement for the reference's per-field
``tf.feature_column.embedding_column`` / ``indicator_column`` stack
(fm/fm.py:75-95, dcn/dcn.py:72-97, xdeepfm/xdeepfm.py:72-92,
deepfm/deepfm.py:37-51) and DIN's raw ``tf.get_variable`` tables
(din/din.py:88-90).

Design: all F fields of a model live in ONE [V_total, D] matrix; a batch of
field-local ids [B, F] is shifted by static per-field offsets into global row
ids and fetched with a single gather. XLA lowers it to one dynamic gather
over device memory instead of 39 small ones, and the backward pass becomes a
single scatter-add.

The wide/linear term (indicator_column one-hots feeding ``dense(1)`` —
fm/fm.py:117-121) is the same structure with D=1: a packed weight-per-row
vector, gathered and summed. No 600k-wide one-hot matmul ever materializes
(the reference README notes that one-hot input_layer dominates its step time,
README.md:64 — this is the fix).

Sharding: tables declare 'replicated' (fits-on-chip fast path, pure DP) or
'row' (row-sharded over the 'model' mesh axis; see
`recsys.parallel.sharded_embedding` for the masked-gather + psum path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from recsys.core.config import EmbeddingConfig
from recsys.ops import nn

#: Packed vocabs are padded to a multiple of this many rows. The value fixes
#: table shapes, and with them initial values and checkpoint layouts.
ROW_PAD = 1024


def field_offsets(field_vocab_sizes: tuple[int, ...]) -> np.ndarray:
    """Static cumulative offsets turning field-local ids into packed rows."""
    return np.concatenate([[0], np.cumsum(field_vocab_sizes[:-1])]).astype(
        np.int32
    )


def pad_rows(total: int, multiple: int = ROW_PAD) -> int:
    """Round the packed vocab up to a multiple of ``multiple`` rows. Row
    sharding over the 'model' mesh axis needs the row count to divide by
    the axis size, which any power-of-two axis up to ROW_PAD does."""
    return (total + multiple - 1) // multiple * multiple


def embedding_init(key, cfg: EmbeddingConfig) -> dict:
    """[V_total, D] packed table, truncated-normal(1/sqrt(D)) per TF default."""
    v = pad_rows(cfg.total_vocab)
    dtype = jnp.dtype(cfg.dtype)
    return {"table": nn.embedding_init(key, (v, cfg.embedding_dim), dtype)}


def linear_init(key, field_vocab_sizes: tuple[int, ...],
                dtype=jnp.float32) -> dict:
    """Packed per-row linear weights (the indicator→dense(1) kernel rows).

    glorot_uniform over the virtual [V_total, 1] dense kernel, matching
    tf.layers.dense's default on the one-hot input layer.
    """
    v = pad_rows(sum(field_vocab_sizes))
    return {
        "w": nn.glorot_uniform(key, (v, 1), dtype)[:, 0],
        "b": jnp.zeros((), dtype),
    }


def to_global_ids(ids: jax.Array, offsets: np.ndarray) -> jax.Array:
    """[B, F] field-local → packed global row ids (static offset add)."""
    return ids + jnp.asarray(offsets)[None, :]


# ---------------------------------------------------------------------------
# Fused table: embedding + wide weight in one row → ONE gather per step.
#
# Packing the wide/linear weight as column D of the embedding row removes a
# separate gather and its backward scatter-add per step.
# ---------------------------------------------------------------------------

def fused_init(key, cfg: EmbeddingConfig) -> dict:
    """[V, D+1] packed table: cols 0..D-1 embedding (truncated-normal
    1/sqrt(D)), col D wide weight (glorot over the virtual [V,1] kernel).
    Plus the wide bias scalar."""
    v = pad_rows(cfg.total_vocab)
    dtype = jnp.dtype(cfg.dtype)
    k1, k2 = jax.random.split(key)
    emb = nn.embedding_init(k1, (v, cfg.embedding_dim), dtype)
    wide = nn.glorot_uniform(k2, (v, 1), dtype)
    return {
        "table": jnp.concatenate([emb, wide], axis=1),
        "b": jnp.zeros((), dtype),
    }


def table_gather(table: jax.Array, gids: jax.Array) -> jax.Array:
    """Packed-table row gather; its gradient is XLA's scatter-add."""
    return jnp.take(table, gids, axis=0)


def table_gather_wm(table_wm: jax.Array, gids: jax.Array) -> jax.Array:
    """W-major-table row gather: [W, V_pad] storage + flat [N] ids →
    [N, W] rows. The gradient lands in the [W, V_pad] storage layout."""
    return jnp.take(table_wm.T, gids, axis=0)


def table_gather_flat(table_flat: jax.Array, gids: jax.Array,
                      num_rows: int, width: int) -> jax.Array:
    """`table_gather` for flat-stored [V·W] tables: the gradient comes back
    flat, in the storage layout the optimizer updates."""
    return jnp.take(table_flat.reshape(num_rows, width), gids, axis=0)


def fused_lookup(params: dict, gids: jax.Array) -> tuple[jax.Array, jax.Array]:
    """[B, F] → (emb [B, F, D], wide [B, F]). One gather."""
    rows = table_gather(params["table"], gids)
    return rows[:, :, :-1], rows[:, :, -1]


def embedding_lookup(params: dict, gids: jax.Array) -> jax.Array:
    """[B, F] global ids → [B, F, D]. One fused gather."""
    return table_gather(params["table"], gids)


def linear_sum(params: dict, gids: jax.Array) -> jax.Array:
    """Wide term: Σ_f w[gid_f] + b → [B, 1]."""
    w = jnp.take(params["w"], gids, axis=0)       # [B, F]
    return jnp.sum(w, axis=1, keepdims=True) + params["b"]
