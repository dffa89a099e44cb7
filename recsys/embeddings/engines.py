"""Embedding engines: how a [B, F] id batch becomes (emb [B,F,D], wide [B,F]).

Replacement for the reference's ``tf.feature_column`` embedding /
indicator stack (fm/fm.py:75-95, deepfm/deepfm.py:37-51). Two engines:

**FusedGatherEngine** — all F fields in ONE packed [V, D+1] table (embedding
columns + the wide/linear weight as column D, see
`recsys.embeddings.table.fused_init`), fetched with a single gather whose
backward is XLA's scatter-add (`table_gather_flat`).

**SplitEngine** (default) — fields are partitioned by vocab size:

- *small fields* (vocab ≤ `threshold`, 25 of the 39 Criteo fields, ~64% of
  the gathered rows) never touch a gather or scatter in training. Their
  lookup is one matmul: a multi-hot [B, Vs] (exactly one hit per field,
  vocab ranges disjoint) times a block-diagonal expansion [Vs, Fs·(D+1)] of
  the small table, so row `v` of field `f` lands in output block `f`. The
  autodiff backward is the transposed matmul, with no scatter rows.
- *big fields* (the hash-capped 100k vocabs) keep the packed gather and
  its scatter-add backward.

**W-major table storage**: big tables are stored TRANSPOSED, ``[D+1,
V_pad]``, so each of the D+1 columns is contiguous over the vocab and the
optimizer's whole-table passes stream dense rows. The gather reads the
transpose (`table.table_gather_wm`) and its gradient comes back in the same
layout.

Engine interface (used by models/ctr.py):
    engine.init(key)                -> params subtree (plain arrays)
    engine.lookup(params, ids[B,F]) -> (emb [B,F,D], wide [B,F])
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from recsys.core.config import EmbeddingConfig
from recsys.embeddings import table as emb_table
from recsys.ops import nn


class EmbParts(NamedTuple):
    """Layout-friendly lookup output (the fast-path engine contract).

    The naive contract — one [B, F, D+1] tensor in ORIGINAL field order —
    makes the concat, the inverse field permutation, the emb/wide split and
    the model-side flatten each copy the whole row tensor. This struct
    keeps everything in the layout its consumers read instead:

    - ``emb_2d`` [B, F·D]: field-major flat embeddings in ENGINE order
      (small fields first, then big). Models consume it directly as the
      DNN/cross input; the field permutation is absorbed by the first
      dense layer's init (permutation-equivalent model family).
    - ``wide`` [B, F]: per-field wide weights, engine order.
    - ``emb_sum`` / ``emb_sq_sum`` [B, D]: Σ_f e_f and Σ_f e_f² — all the
      FM pairwise term needs (`interactions.fm_pairwise_from_sums`);
      reduced per part so the 3-D form never materializes.
    - ``field_order`` [F] numpy: engine position → original field index
      (static; lets models pick original-field subsets of ``wide`` without
      reordering data, e.g. xDeepFM's cat-only linear term).
    """

    emb_2d: jax.Array
    wide: jax.Array
    emb_sum: jax.Array
    emb_sq_sum: jax.Array
    field_order: np.ndarray
    #: the engine-order [B, F_part·D] pieces BEFORE concatenation (small,
    #: big). Models whose only use of emb_2d is a dense layer feed these
    #: through ops.nn.dense's list form instead — the concat (and its
    #: cotangent split) then dead-code-eliminates out of the step
    emb_parts: tuple | None = None

    def emb_3d(self, num_fields: int, dim: int) -> jax.Array:
        """[B, F, D] in engine order — only for models that genuinely need
        the 3-D form (xDeepFM's CIN); materializes one relayout."""
        return self.emb_2d.reshape(self.emb_2d.shape[0], num_fields, dim)

#: Fields with vocab ≤ this go through the one-hot-matmul path.
SPLIT_THRESHOLD = 2048


def _parts_from_rows(emb: jax.Array, wide: jax.Array,
                     field_order: np.ndarray) -> EmbParts:
    """EmbParts from a [B, F, D] + [B, F] lookup (the row-tensor engines)."""
    b, f, d = emb.shape
    return EmbParts(
        emb_2d=emb.reshape(b, f * d),
        wide=wide,
        emb_sum=jnp.sum(emb, axis=1),
        emb_sq_sum=jnp.sum(jnp.square(emb), axis=1),
        field_order=field_order,
    )


def _matmul_dtype():
    """bf16 one-hot matmuls on accelerators (the one-hot side is exact in
    bf16, the table side is rounded to bf16); f32 on CPU, whose dot thunk
    lacks BF16xBF16=F32 (tests run there)."""
    return jnp.float32 if jax.default_backend() == "cpu" else jnp.bfloat16


def _field_sums(x2d: jax.Array, f: int, d: int):
    """(Σ_f e_f, Σ_f e_f²) [B, D] in f32 from field-major flat [B, F·D]."""
    x3 = x2d.astype(jnp.float32).reshape(x2d.shape[0], f, d)
    return jnp.sum(x3, axis=1), jnp.sum(jnp.square(x3), axis=1)


def _multi_hot(sub: jax.Array, sizes: tuple[int, ...]) -> jax.Array:
    """[B, Fs] field-LOCAL ids → multi-hot [B, Σ sizes] (one hit per field).

    Built per field against a ``size_f``-wide iota then concatenated: total
    compares = B·Σ_f v_f, where comparing every field against the full
    Σv_f-wide iota would take B·Fs·Σv_f (25× more at the Criteo schema)."""
    dt = _matmul_dtype()
    parts = []
    for f, v in enumerate(sizes):
        iota = jax.lax.broadcasted_iota(jnp.int32, (1, v), 1)
        parts.append((sub[:, f][:, None] == iota).astype(dt))
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)


@dataclass(frozen=True)
class FusedGatherEngine:
    """All fields through one packed flat [V·(D+1)] table + single gather."""

    cfg: EmbeddingConfig

    @property
    def offsets(self):
        return emb_table.field_offsets(self.cfg.field_vocab_sizes)

    @property
    def width(self) -> int:
        return self.cfg.embedding_dim + 1

    @property
    def v_pad(self) -> int:
        return emb_table.pad_rows(self.cfg.total_vocab)

    def init(self, key) -> dict:
        p = emb_table.fused_init(key, self.cfg)
        return {"table_flat": p["table"].reshape(-1), "b": p["b"]}

    def table2d(self, params) -> jax.Array:
        return params["table_flat"].reshape(self.v_pad, self.width)

    def lookup(self, params, ids, train: bool = True):
        del train  # gather is already the inference-optimal path
        gids = emb_table.to_global_ids(ids, self.offsets)
        rows = emb_table.table_gather_flat(params["table_flat"], gids,
                                           self.v_pad, self.width)
        return rows[:, :, :-1], rows[:, :, -1]

    @property
    def field_order(self) -> np.ndarray:
        return np.arange(len(self.cfg.field_vocab_sizes), dtype=np.int32)

    def lookup_parts(self, params, ids, train: bool = True) -> EmbParts:
        emb, wide = self.lookup(params, ids, train=train)
        return _parts_from_rows(emb, wide, self.field_order)

    def lookup_parts_sharded(self, params, ids, axis_name: str = "model",
                             exact: bool = False,
                             cap_factor: float = 2.0) -> EmbParts:
        emb, wide = self.lookup_sharded(params, ids, axis_name,
                                        exact=exact, cap_factor=cap_factor)
        return _parts_from_rows(emb, wide, self.field_order)

    def lookup_sharded(self, params, ids, axis_name: str = "model",
                       exact: bool = False, cap_factor: float = 2.0):
        """Inside shard_map: params['table_flat'] is this member's row shard;
        lookup via dedup + all-to-all (recsys.parallel.sharded_embedding)."""
        from recsys.parallel import sharded_embedding as SE

        local = params["table_flat"].reshape(-1, self.width)
        gids = emb_table.to_global_ids(ids, self.offsets)
        rows = SE.a2a_embedding_lookup(local, gids, axis_name, exact=exact,
                                       cap_factor=cap_factor)
        return rows[:, :, :-1], rows[:, :, -1]

    def a2a_overflow(self, ids, num_data: int, num_model: int,
                     cap_factor: float = 2.0) -> int:
        """Host-side lossless-capacity check for a batch: unique ids that
        would exceed the per-owner a2a capacity at ``cap_factor`` (0 ==
        lossless). Mirrors lookup_sharded's id routing, per data shard."""
        from recsys.parallel import sharded_embedding as SE

        gids = np.asarray(ids) + np.asarray(self.offsets)[None, :]
        shard_rows = self.v_pad // num_model
        per_shard = np.array_split(gids, num_data, axis=0)
        return max(SE.a2a_overflow(s, num_model, shard_rows, cap_factor)
                   for s in per_shard)


@dataclass(frozen=True)
class SplitEngine:
    cfg: EmbeddingConfig
    threshold: int = SPLIT_THRESHOLD

    # ---- static field partition -----------------------------------------
    def _partition(self):
        small = [f for f, v in enumerate(self.cfg.field_vocab_sizes)
                 if v <= self.threshold]
        big = [f for f, v in enumerate(self.cfg.field_vocab_sizes)
               if v > self.threshold]
        return small, big

    def _sizes(self, fields):
        return tuple(self.cfg.field_vocab_sizes[f] for f in fields)

    @property
    def width(self) -> int:
        return self.cfg.embedding_dim + 1

    def init(self, key) -> dict:
        small, big = self._partition()
        k1, k2 = jax.random.split(key)
        params: dict = {}
        if small:
            s_cfg = EmbeddingConfig(field_vocab_sizes=self._sizes(small),
                                    embedding_dim=self.cfg.embedding_dim)
            params["small"] = emb_table.fused_init(k1, s_cfg)["table"]
        if big:
            b_cfg = EmbeddingConfig(field_vocab_sizes=self._sizes(big),
                                    embedding_dim=self.cfg.embedding_dim)
            # W-major [W, V_pad]: see the module docstring
            params["big_wm"] = emb_table.fused_init(
                k2, b_cfg)["table"].T
        params["b"] = jnp.zeros((), jnp.float32)
        return params

    def lookup(self, params, ids, train: bool = True):
        small, big = self._partition()
        w = self.width
        outs = []
        if small:
            # the one-hot matmul exists to avoid the SCATTER in the backward
            # pass; inference has no backward, and at serving batch sizes a
            # plain gather is ~10× cheaper than the [B,Vs] matmul
            rows_fn = self._small_rows if train else self._small_rows_gather
            outs.append(rows_fn(params["small"], ids, small))
        if big:
            gids = self._big_gids(ids, big)
            rows = emb_table.table_gather_wm(params["big_wm"],
                                             gids.reshape(-1))
            outs.append(rows.reshape(*gids.shape, w))
        rows = jnp.concatenate(outs, axis=1)
        # restore original field order (static inverse permutation)
        inv = np.argsort(np.asarray(small + big))
        rows = jnp.take(rows, jnp.asarray(inv), axis=1)
        return rows[:, :, :-1], rows[:, :, -1]

    def lookup_sharded(self, params, ids, axis_name: str = "model",
                       exact: bool = False, cap_factor: float = 2.0):
        """Inside shard_map: 'small' is replicated (every member runs the
        same tiny matmul), 'big_wm' is this member's shard ([W, V/m],
        W-major), fetched
        via dedup + all-to-all."""
        from recsys.parallel import sharded_embedding as SE

        small, big = self._partition()
        w = self.width
        outs = []
        if small:
            outs.append(self._small_rows(params["small"], ids, small))
        if big:
            gids = self._big_gids(ids, big)
            # member's shard is [W, V/m]; the a2a path consumes row-major
            local = params["big_wm"].T
            outs.append(SE.a2a_embedding_lookup(local, gids, axis_name,
                                                exact=exact,
                                                cap_factor=cap_factor))
        rows = jnp.concatenate(outs, axis=1)
        inv = np.argsort(np.asarray(small + big))
        rows = jnp.take(rows, jnp.asarray(inv), axis=1)
        return rows[:, :, :-1], rows[:, :, -1]

    def a2a_overflow(self, ids, num_data: int, num_model: int,
                     cap_factor: float = 2.0) -> int:
        """Host-side lossless-capacity check (see FusedGatherEngine): only
        the big fields travel over the all-to-all in this engine."""
        from recsys.parallel import sharded_embedding as SE

        small, big = self._partition()
        if not big:
            return 0
        b_sizes = self._sizes(big)
        offsets = emb_table.field_offsets(b_sizes)
        gids = (np.asarray(ids)[:, np.asarray(big, np.int64)]
                + np.asarray(offsets)[None, :])
        shard_rows = emb_table.pad_rows(sum(b_sizes)) // num_model
        per_shard = np.array_split(gids, num_data, axis=0)
        return max(SE.a2a_overflow(s, num_model, shard_rows, cap_factor)
                   for s in per_shard)

    @property
    def field_order(self) -> np.ndarray:
        small, big = self._partition()
        return np.asarray(small + big, np.int32)

    def _small_parts(self, table, ids, small_fields, train: bool):
        """(emb_2d [B, Fs·D], wide [B, Fs]) with emb and wide SEPARATED at
        the matmul: one multi-hot @ [Vs, Fs·D + Fs] block matrix whose
        first Fs·D columns are per-field embedding blocks and last Fs are
        the wide weights, so downstream never slices a [B, Fs, D+1]
        tensor."""
        sizes = self._sizes(small_fields)
        fs, d = len(sizes), self.cfg.embedding_dim
        vs = int(sum(sizes))
        if not train:
            rows = self._small_rows_gather(table, ids, small_fields)
            emb = rows[:, :, :d]
            return emb.reshape(ids.shape[0], fs * d), rows[:, :, d]
        sub = ids[:, np.asarray(small_fields, np.int32)]
        oh = _multi_hot(sub, sizes)

        wblk = jnp.zeros((vs, fs * d + fs), table.dtype)
        lo = 0
        for f, v in enumerate(sizes):
            wblk = jax.lax.dynamic_update_slice(
                wblk, table[lo:lo + v, :d], (lo, f * d))
            wblk = jax.lax.dynamic_update_slice(
                wblk, table[lo:lo + v, d:d + 1], (lo, fs * d + f))
            lo += v
        out = jnp.dot(oh, wblk.astype(oh.dtype),
                      preferred_element_type=jnp.float32)   # [B, Fs·D+Fs]
        return out[:, :fs * d], out[:, fs * d:]

    def _big_gids(self, ids, big_fields):
        b_sizes = self._sizes(big_fields)
        offsets = emb_table.field_offsets(b_sizes)
        return ids[:, np.asarray(big_fields, np.int32)] + \
            jnp.asarray(offsets)[None, :]

    def _big_parts(self, params, ids, big_fields):
        """(emb_2d [B, Fb·D], wide [B, Fb]) from the W-major gather: the
        [B·Fb, W] rows are viewed as [B, Fb, W] and split by slicing."""
        d = self.cfg.embedding_dim
        gids = self._big_gids(ids, big_fields)
        b, fb = gids.shape
        rows = emb_table.table_gather_wm(params["big_wm"],
                                         gids.reshape(-1))    # [B·Fb, W]
        rows = rows.reshape(b, fb, self.width)
        return rows[:, :, :d].reshape(b, fb * d), rows[:, :, d]

    def lookup_parts(self, params, ids, train: bool = True) -> EmbParts:
        """The layout-friendly lookup (see EmbParts): small fields stay 2-D
        out of the matmul, big fields contribute one [B, Fb, D+1] gather;
        field order = engine order (small, then big)."""
        small, big = self._partition()
        d = self.cfg.embedding_dim
        b = ids.shape[0]
        emb2_parts, wide_parts = [], []
        emb_sum = jnp.zeros((b, d), jnp.float32)
        emb_sq_sum = jnp.zeros((b, d), jnp.float32)
        if small:
            s_emb2, s_wide = self._small_parts(params["small"], ids, small,
                                               train)
            emb2_parts.append(s_emb2)
            wide_parts.append(s_wide)
            s_sum, s_sq = _field_sums(s_emb2, len(small), d)
            emb_sum = emb_sum + s_sum
            emb_sq_sum = emb_sq_sum + s_sq
        if big:
            bemb2, bwide = self._big_parts(params, ids, big)
            emb2_parts.append(bemb2)
            wide_parts.append(bwide)
            b_sum, b_sq = _field_sums(bemb2, len(big), d)
            emb_sum = emb_sum + b_sum
            emb_sq_sum = emb_sq_sum + b_sq
        return EmbParts(
            emb_2d=(emb2_parts[0] if len(emb2_parts) == 1
                    else jnp.concatenate(emb2_parts, axis=1)),
            wide=(wide_parts[0] if len(wide_parts) == 1
                  else jnp.concatenate(wide_parts, axis=1)),
            emb_sum=emb_sum,
            emb_sq_sum=emb_sq_sum,
            field_order=self.field_order,
            emb_parts=tuple(emb2_parts),
        )

    def lookup_parts_sharded(self, params, ids, axis_name: str = "model",
                             exact: bool = False,
                             cap_factor: float = 2.0) -> EmbParts:
        """Parts lookup inside shard_map: same math/order as lookup_parts,
        big rows fetched via dedup + all-to-all — local-vs-sharded model
        outputs stay bit-comparable (tests/test_spmd.py)."""
        from recsys.parallel import sharded_embedding as SE

        small, big = self._partition()
        d = self.cfg.embedding_dim
        b = ids.shape[0]
        emb2_parts, wide_parts = [], []
        emb_sum = jnp.zeros((b, d), jnp.float32)
        emb_sq_sum = jnp.zeros((b, d), jnp.float32)
        if small:
            s_emb2, s_wide = self._small_parts(params["small"], ids, small,
                                               train=True)
            emb2_parts.append(s_emb2)
            wide_parts.append(s_wide)
            s_sum, s_sq = _field_sums(s_emb2, len(small), d)
            emb_sum = emb_sum + s_sum
            emb_sq_sum = emb_sq_sum + s_sq
        if big:
            gids = self._big_gids(ids, big)
            local = params["big_wm"].T     # member's [W, V/m] shard
            rows = SE.a2a_embedding_lookup(local, gids, axis_name,
                                           exact=exact,
                                           cap_factor=cap_factor)
            bemb = rows[:, :, :d]
            bemb2 = bemb.reshape(b, len(big) * d)
            emb2_parts.append(bemb2)
            wide_parts.append(rows[:, :, d])
            b_sum, b_sq = _field_sums(bemb2, len(big), d)
            emb_sum = emb_sum + b_sum
            emb_sq_sum = emb_sq_sum + b_sq
        return EmbParts(
            emb_2d=(emb2_parts[0] if len(emb2_parts) == 1
                    else jnp.concatenate(emb2_parts, axis=1)),
            wide=(wide_parts[0] if len(wide_parts) == 1
                  else jnp.concatenate(wide_parts, axis=1)),
            emb_sum=emb_sum,
            emb_sq_sum=emb_sq_sum,
            field_order=self.field_order,
            emb_parts=tuple(emb2_parts),
        )

    def _small_rows_gather(self, table, ids, small_fields):
        """[B, Fs, D+1] via plain row gather — the inference path."""
        sizes = self._sizes(small_fields)
        offsets = emb_table.field_offsets(sizes)
        sub = ids[:, np.asarray(small_fields, np.int32)]
        gids = sub + jnp.asarray(offsets)[None, :]
        return jnp.take(table, gids, axis=0)

    def _small_rows(self, table, ids, small_fields):
        """[B, Fs, D+1] via multi-hot @ block-diagonal table expansion."""
        sizes = self._sizes(small_fields)
        fs, w = len(sizes), self.width
        vs = int(sum(sizes))
        sub = ids[:, np.asarray(small_fields, np.int32)]  # [B, Fs] local ids
        oh = _multi_hot(sub, sizes)

        # block-diagonal weight [Vs, Fs·W]: field f's vocab rows sit in
        # output block f, so oh @ wblk routes each id to its field's slot.
        wblk = jnp.zeros((vs, fs * w), table.dtype)
        lo = 0
        for f, v in enumerate(sizes):
            wblk = jax.lax.dynamic_update_slice(
                wblk, table[lo:lo + v], (lo, f * w))
            lo += v

        out = jnp.dot(oh, wblk.astype(oh.dtype),
                      preferred_element_type=jnp.float32)  # [B, Fs·W]
        return out.reshape(ids.shape[0], fs, w)


def make_engine(cfg: EmbeddingConfig, name: str = "split",
                threshold: int = SPLIT_THRESHOLD):
    if name == "split":
        # degenerate partitions (all fields on one side) are handled inside
        return SplitEngine(cfg, threshold)
    if name == "fused":
        return FusedGatherEngine(cfg)
    raise ValueError(f"unknown embedding engine {name!r}")
