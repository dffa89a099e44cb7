"""Row-sharded embedding lookup over the 'model' mesh axis.

Replacement for TF's internal partitioned-variable hashed-embedding
machinery (SURVEY §2.2 row 1; reference invokes it via
``tf.feature_column.embedding_column`` on hash columns, fm/fm.py:88-95):
when the packed vocab should not be replicated per chip (full-vocab Criteo is
45M rows ≈ 3 GB of table + 6 GB of Adam state at D+1=17), the [V, W] table is
row-split across the ``model`` axis and lookup becomes a collective exchange.

Two implementations, both called inside `shard_map`:

**a2a_embedding_lookup** (the product path) — dedup + all-to-all:

1. the flat id stream [N] of the (data-shard-local) batch is split into E
   chunks, one per model-axis member — members now hold *different* ids;
2. each member sorts its chunk and deduplicates (duplicate ids collapse to
   one wire row; their gradients pre-sum locally in the transpose);
3. unique ids are exchanged with their owner shards via ``all_to_all``
   ([E, cap] int32 — ids are 4 B/row vs 4·W B/row for activations);
4. each owner gathers its local rows (`table_gather`, scatter-add backward)
   and sends them back via the second ``all_to_all`` ([E, cap, W]);
5. members un-dedup/un-sort their chunk and an ``all_gather`` over the model
   axis reassembles the full [N, W] activation.

Collective sizes per member per step (documented contract): ids
``E·cap·4 B``, activations ``2·E·cap·4·W B``, plus the all_gather
``N·W·4·(E−1)/E B``, with ``cap = ceil(cap_factor·N/E²)`` — i.e. the
exchange volume scales with the deduplicated chunk size, NOT with B·F·E the
way a dense psum does. Ids that overflow an owner's ``cap`` (only possible
when the id→owner distribution is skewed beyond ``cap_factor``) read as
zero rows; `a2a_overflow` measures the actual overflow for a batch so
drivers can size ``cap_factor`` (default 2.0; tests use ``exact=True`` which
sets cap so overflow is impossible).

The whole path is built from differentiable primitives (sorts and index math
are zero-cotangent), so JAX's shard_map autodiff derives the backward:
gather → segment-sum scatter into owner shards, all_gather → psum_scatter.

**psum_embedding_lookup** — the dense fallback: every member masks-gathers
its hits of the FULL [N] stream and a psum over the model axis reconstructs
the activation. Simple and exact, but moves the entire [N, W] activation
through an all-reduce regardless of duplication; kept as the oracle the
a2a path is equivalence-tested against (tests/test_embeddings.py).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from recsys.core.mesh import MODEL_AXIS
from recsys.embeddings import table as emb_table


def shard_rows_of(total_rows: int, num_shards: int) -> int:
    if total_rows % num_shards != 0:
        raise ValueError(
            f"padded vocab {total_rows} not divisible by model axis {num_shards}"
        )
    return total_rows // num_shards


# ---------------------------------------------------------------------------
# Dense psum fallback (round-1 design; the equivalence oracle)
# ---------------------------------------------------------------------------


def psum_embedding_lookup(
    local_table: jax.Array,   # [V/m, W] this shard's rows
    gids: jax.Array,          # [B_local, F] global packed ids (replicated on model axis)
    axis_name: str = MODEL_AXIS,
) -> jax.Array:
    shard_rows = local_table.shape[0]
    lo = jax.lax.axis_index(axis_name) * shard_rows
    local = gids - lo
    hit = (local >= 0) & (local < shard_rows)
    safe = jnp.where(hit, local, 0)
    emb = jnp.take(local_table, safe, axis=0)            # [B, F, W]
    emb = jnp.where(hit[..., None], emb, 0.0)
    return jax.lax.psum(emb, axis_name)


def sharded_linear_sum(
    local_w: jax.Array,       # [V/m] this shard's wide weights
    bias: jax.Array,          # scalar (replicated)
    gids: jax.Array,          # [B_local, F]
    axis_name: str = MODEL_AXIS,
) -> jax.Array:
    shard_rows = local_w.shape[0]
    lo = jax.lax.axis_index(axis_name) * shard_rows
    local = gids - lo
    hit = (local >= 0) & (local < shard_rows)
    safe = jnp.where(hit, local, 0)
    w = jnp.where(hit, jnp.take(local_w, safe, axis=0), 0.0)  # [B, F]
    partial = jnp.sum(w, axis=1, keepdims=True)
    return jax.lax.psum(partial, axis_name) + bias


# ---------------------------------------------------------------------------
# Dedup + all-to-all (SURVEY §2.2 row 1 / §7.3)
# ---------------------------------------------------------------------------


def a2a_capacity(n_flat: int, num_shards: int, cap_factor: float,
                 exact: bool) -> int:
    """Per-(src,dst) id capacity. ``exact`` sizes for the worst case (every
    unique id of a chunk owned by one shard) — no overflow possible."""
    nc = -(-n_flat // num_shards)
    if exact:
        return nc
    return min(nc, max(1, math.ceil(cap_factor * nc / num_shards)))


def a2a_embedding_lookup(
    local_table: jax.Array,   # [V/m, W] this shard's rows
    gids: jax.Array,          # [B_local, F] global ids (replicated on model axis)
    axis_name: str = MODEL_AXIS,
    cap_factor: float = 2.0,
    exact: bool = False,
) -> jax.Array:
    e = jax.lax.axis_size(axis_name)
    m = jax.lax.axis_index(axis_name)
    shard_rows = local_table.shape[0]
    v_total = shard_rows * e
    w = local_table.shape[1]
    b, f = gids.shape
    n = b * f

    flat = gids.reshape(-1)
    nc = -(-n // e)                      # chunk length per member
    n_pad = nc * e
    if n_pad != n:
        # pad with an out-of-range id: reads as a zero row, grads drop
        flat = jnp.concatenate(
            [flat, jnp.full((n_pad - n,), v_total, jnp.int32)]
        )
    cap = a2a_capacity(n_pad, e, cap_factor, exact)

    # 1. my chunk (members process disjoint slices of the id stream)
    chunk = jax.lax.dynamic_slice(flat, (m * nc,), (nc,))

    # 2. sort + dedup: duplicates collapse onto their first occurrence
    sid, order = jax.lax.sort_key_val(chunk, jnp.arange(nc, dtype=jnp.int32))
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sid[1:] != sid[:-1]]
    )
    urank = jnp.cumsum(first.astype(jnp.int32)) - 1        # [nc]
    # compaction: usort[urank[p]] = sid[p] (sorted ascending); dead slots
    # stay at the out-of-range sentinel so they route nowhere
    usort = jnp.full((nc,), v_total, jnp.int32).at[urank].set(
        sid, mode="drop"
    )

    # 3. pack per-owner send buffers [E, cap] and exchange ids
    bounds = jnp.arange(e + 1, dtype=jnp.int32) * shard_rows
    start = jnp.searchsorted(usort, bounds[:-1], side="left").astype(jnp.int32)
    end = jnp.searchsorted(usort, bounds[1:], side="left").astype(jnp.int32)
    k = jax.lax.broadcasted_iota(jnp.int32, (e, cap), 1)
    idx = start[:, None] + k
    valid = k < (end - start)[:, None]
    send_ids = jnp.where(valid, jnp.take(usort, jnp.clip(idx, 0, nc - 1)),
                         v_total)
    recv_ids = jax.lax.all_to_all(send_ids, axis_name, 0, 0, tiled=False)

    # 4. owner-side gather (scatter-add backward via table_gather)
    lid = recv_ids - m * shard_rows
    hit = (lid >= 0) & (lid < shard_rows)
    rows = emb_table.table_gather(local_table, jnp.where(hit, lid, 0))
    rows = jnp.where(hit[..., None], rows, 0.0)            # [E, cap, W]
    got = jax.lax.all_to_all(rows, axis_name, 0, 0, tiled=False)

    # 5. un-dedup + un-sort my chunk, then reassemble the full stream
    owner = jnp.clip(usort // shard_rows, 0, e - 1)
    slot = jnp.arange(nc, dtype=jnp.int32) - jnp.take(start, owner)
    ok = (slot >= 0) & (slot < cap) & (usort < v_total)
    uflat = jnp.where(ok, owner * cap + slot, 0)
    rows_u = jnp.take(got.reshape(e * cap, w), uflat, axis=0)
    rows_u = jnp.where(ok[:, None], rows_u, 0.0)           # [nc_unique, W]
    rows_sorted = jnp.take(rows_u, urank, axis=0)          # [nc, W]
    chunk_rows = jnp.zeros((nc, w), rows_sorted.dtype).at[order].set(
        rows_sorted
    )
    full = jax.lax.all_gather(chunk_rows, axis_name, axis=0, tiled=True)
    return full[:n].reshape(b, f, w)


def a2a_overflow(gids, num_shards: int, shard_rows: int,
                 cap_factor: float = 2.0) -> int:
    """Host-side diagnostic: how many unique ids of a batch would overflow
    the per-owner capacity at this ``cap_factor`` (0 == lossless)."""
    import numpy as np

    flat = np.asarray(gids).reshape(-1)
    nc = -(-flat.size // num_shards)
    cap = a2a_capacity(nc * num_shards, num_shards, cap_factor, exact=False)
    dropped = 0
    for c in range(num_shards):
        chunk = flat[c * nc:(c + 1) * nc]
        uniq = np.unique(chunk)
        owners = np.clip(uniq // shard_rows, 0, num_shards - 1)
        counts = np.bincount(owners, minlength=num_shards)
        dropped += int(np.maximum(counts - cap, 0).sum())
    return dropped
