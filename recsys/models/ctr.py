"""Criteo CTR model zoo: FM, DeepFM, DCN, xDeepFM, DNN, WideLinear.

Each model is a thin composition over the shared subsystems (packed embedding
tables, interaction ops, MLP tower), mirroring the semantics of the
reference's copy-pasted ``model_fn`` bodies — see per-model docstrings for
the exact file:line parity map.

All bodies are jit-compiled as one XLA program per step: the embedding
gather, interaction math, dense towers and loss fuse into a handful of
kernels. Batch-norm state threads through explicitly (the reference's
BN moving stats silently never updated — a TF1 UPDATE_OPS bug we fix, see
recsys.ops.nn).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from recsys.core.config import CriteoConfig, EmbeddingConfig, ModelConfig
from recsys.embeddings import table as emb_table
from recsys.models.api import EmbOps, LOCAL_EMB_OPS, Model, register
from recsys.ops import interactions, nn


def _final_dense_init(key, in_dim: int) -> dict:
    return nn.dense_init(key, in_dim, 1)


def _squeeze_logits(x: jax.Array) -> jax.Array:
    return x[:, 0] if x.ndim == 2 else x


class _CriteoBase:
    """Shared wiring: embedding engine + offsets for the 39 Criteo fields."""

    def __init__(self, criteo: CriteoConfig, cfg: ModelConfig):
        from recsys.embeddings import engines

        self.criteo = criteo
        self.cfg = cfg
        self.offsets = emb_table.field_offsets(criteo.field_vocab_sizes)
        self.emb_cfg = EmbeddingConfig(
            field_vocab_sizes=criteo.field_vocab_sizes,
            embedding_dim=cfg.embedding_dim,
        )
        self.num_fields = len(criteo.field_vocab_sizes)
        self.engine = engines.make_engine(self.emb_cfg, cfg.emb_engine,
                                          threshold=cfg.split_threshold)

    @property
    def meta(self) -> dict:
        # 'engine' lets drivers run host-side capacity checks
        # (engine.a2a_overflow) before entering the sharded path
        return {"emb_width": self.cfg.embedding_dim + 1,
                "engine": self.engine}

    def gids(self, batch) -> jax.Array:
        return emb_table.to_global_ids(batch["ids"], self.offsets)

    def init_fused(self, key) -> dict:
        """Engine-owned tables (+ shared wide bias)."""
        params = self.engine.init(key)
        if "b" not in params:
            params = dict(params, b=jax.numpy.zeros((), jax.numpy.float32))
        return {"tables": params}

    def lookup(self, params, batch, emb_ops: EmbOps, train: bool = True):
        """(emb [B,F,D], wide [B,F]) — local engine fast path by default; an
        EmbOps with ``sharded=True`` (the SPMD path inside shard_map) routes
        through the engine's dedup + all-to-all sharded lookup. ``train=False``
        lets the engine pick its inference path (plain gather — no scatter to
        avoid when there's no backward)."""
        if emb_ops.sharded:
            return self.engine.lookup_sharded(
                params["tables"], batch["ids"], exact=emb_ops.a2a_exact,
                cap_factor=emb_ops.a2a_cap_factor)
        return self.engine.lookup(params["tables"], batch["ids"], train=train)

    def lookup_parts(self, params, batch, emb_ops: EmbOps,
                     train: bool = True):
        """Layout-friendly lookup (engines.EmbParts): embeddings arrive 2-D
        in ENGINE field order with FM sums pre-reduced — none of the
        [B, F, D+1] concat/permute/split intermediates of the row-tensor
        contract materialize. The field
        permutation is static and absorbed by the first dense layer's init;
        models needing original-field subsets use ``parts.field_order``."""
        if emb_ops.sharded:
            return self.engine.lookup_parts_sharded(
                params["tables"], batch["ids"], exact=emb_ops.a2a_exact,
                cap_factor=emb_ops.a2a_cap_factor)
        return self.engine.lookup_parts(params["tables"], batch["ids"],
                                        train=train)


# ---------------------------------------------------------------------------
# FM — fm/fm.py:115-170
# ---------------------------------------------------------------------------

@register("fm")
def make_fm(criteo: CriteoConfig = CriteoConfig(),
            cfg: ModelConfig = ModelConfig(name="fm")) -> Model:
    """Factorization machine.

    Parity: linear term = relu(dense(one-hot indicators)) over all 39
    bucketized/hashed fields (fm/fm.py:117-121) — realized as a packed
    weight-per-row gather (no one-hot ever materializes); 2nd-order term via
    sum-square−square-sum (fm/fm.py:124-129); logits =
    dense(concat(y_1d, y_2d)) (fm/fm.py:131-132).
    """
    base = _CriteoBase(criteo, cfg)

    def init(key):
        k1, k2 = jax.random.split(key)
        params = base.init_fused(k1)
        params["final"] = _final_dense_init(k2, 2)
        return params, {}

    def apply(params, state, batch, *, train=False, rng=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        y_1d = jax.nn.relu(
            jnp.sum(parts.wide, axis=1, keepdims=True)
            + params["tables"]["b"]
        )
        y_2d = interactions.fm_pairwise_from_sums(
            parts.emb_sum, parts.emb_sq_sum)                       # [B,1]
        logits = nn.dense(params["final"], jnp.concatenate([y_1d, y_2d], -1))
        return _squeeze_logits(logits), state

    return Model("fm", init, apply, meta=base.meta)


# ---------------------------------------------------------------------------
# DeepFM — deepfm/deepfm.py:73-150 (README Criteo config: DNN 100,100)
# ---------------------------------------------------------------------------

@register("deepfm")
def make_deepfm(criteo: CriteoConfig = CriteoConfig(),
                cfg: ModelConfig = ModelConfig(name="deepfm")) -> Model:
    """DeepFM: wide + FM 2nd-order + DNN tower sharing one embedding space.

    Parity: y_1d = relu(dense(linear one-hots)) (deepfm/deepfm.py:90-91);
    y_2d = FM identity (deepfm/deepfm.py:93-98); y_dnn = relu-dense over the
    flattened embeddings through [dense→BN→dropout]×L then dense(1, relu)
    (deepfm/deepfm.py:100-108); logits = dense(concat(y_1d, y_2d, y_dnn))
    (deepfm/deepfm.py:110-112).
    """
    base = _CriteoBase(criteo, cfg)
    flat_dim = base.num_fields * cfg.embedding_dim

    def init(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        params = base.init_fused(k1)
        mlp_p, mlp_s = nn.mlp_init(k2, flat_dim, cfg.deep_layers, cfg.use_bn)
        params["dnn"] = mlp_p
        params["dnn_out"] = nn.dense_init(k3, cfg.deep_layers[-1], 1)
        params["final"] = _final_dense_init(k4, 3)
        return params, {"dnn": mlp_s}

    def apply(params, state, batch, *, train=False, rng=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        y_1d = jax.nn.relu(
            jnp.sum(parts.wide, axis=1, keepdims=True)
            + params["tables"]["b"]
        )
        y_2d = interactions.fm_pairwise_from_sums(
            parts.emb_sum, parts.emb_sq_sum)
        # first dense consumes the engine parts directly (nn.dense list
        # form) — the emb_2d concat dead-code-eliminates from this model
        mlp_in = parts.emb_parts if parts.emb_parts is not None \
            else parts.emb_2d
        h, dnn_s = nn.mlp_apply(
            params["dnn"], state["dnn"], mlp_in,
            train=train, dropout_rate=cfg.dropout, rng=rng,
        )
        y_dnn = nn.dense(params["dnn_out"], h, activation=jax.nn.relu)
        logits = nn.dense(
            params["final"], jnp.concatenate([y_1d, y_2d, y_dnn], -1)
        )
        return _squeeze_logits(logits), {"dnn": dnn_s}

    return Model("deepfm", init, apply, meta=base.meta)


# ---------------------------------------------------------------------------
# DCN — dcn/dcn.py:117-190
# ---------------------------------------------------------------------------

@register("dcn")
def make_dcn(criteo: CriteoConfig = CriteoConfig(),
             cfg: ModelConfig = ModelConfig(name="dcn", embedding_dim=16,
                                            cross_layers=4)) -> Model:
    """Deep & Cross: explicit rank-1 cross layers + deep tower.

    Parity: x0 = flattened field embeddings (dcn/dcn.py:123-128 — all 39
    fields embedded, dense fields bucketized→embedded per dcn/readme.md);
    cross x_{l+1} = x0·(x_l⊤w) + x_l + b (dcn/dcn.py:132-142); deep tower
    with BN+dropout (dcn/dcn.py:144-149); logits = dense(concat(dnn, x_L))
    (dcn/dcn.py:151-152). The reference computes a linear branch it never
    uses (dcn/dcn.py:122,129-130) — intentionally not reproduced.
    """
    base = _CriteoBase(criteo, cfg)
    flat_dim = base.num_fields * cfg.embedding_dim

    def init(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        params = base.init_fused(k1)
        params["cross"] = interactions.cross_init(k2, flat_dim, cfg.cross_layers)
        mlp_p, mlp_s = nn.mlp_init(k3, flat_dim, cfg.deep_layers, cfg.use_bn)
        params["dnn"] = mlp_p
        params["final"] = _final_dense_init(k4, cfg.deep_layers[-1] + flat_dim)
        return params, {"dnn": mlp_s}

    def apply(params, state, batch, *, train=False, rng=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        x0 = parts.emb_2d
        xl = interactions.cross_apply(params["cross"], x0)
        h, dnn_s = nn.mlp_apply(
            params["dnn"], state["dnn"], x0,
            train=train, dropout_rate=cfg.dropout, rng=rng,
        )
        logits = nn.dense(params["final"], jnp.concatenate([h, xl], -1))
        return _squeeze_logits(logits), {"dnn": dnn_s}

    return Model("dcn", init, apply, meta=base.meta)


# ---------------------------------------------------------------------------
# xDeepFM — xdeepfm/xdeepfm.py:123-233
# ---------------------------------------------------------------------------

@register("xdeepfm")
def make_xdeepfm(criteo: CriteoConfig = CriteoConfig(),
                 cfg: ModelConfig = ModelConfig(name="xdeepfm")) -> Model:
    """xDeepFM: linear + CIN + DNN.

    Parity: linear branch over [13 raw log-scaled continuous + 26 indicator
    one-hots] → dense(1, relu) (xdeepfm/xdeepfm.py:72-92,127-131) — realized
    as w·dense_vals + packed-weight gather over the categorical fields; CIN
    with direct connect and sum-pool (xdeepfm/xdeepfm.py:135-182) as the
    einsum chain in `interactions.cin_apply_xla`; DNN tower
    (xdeepfm/xdeepfm.py:184-192); logits = dense(concat(linear, cin, dnn))
    (xdeepfm/xdeepfm.py:194-195).
    """
    base = _CriteoBase(criteo, cfg)
    flat_dim = base.num_fields * cfg.embedding_dim
    n_cont = len(criteo.cont_boundaries)

    def init(key):
        ks = jax.random.split(key, 7)
        # fused table: wide column serves the 26 indicator one-hots; the
        # wide entries of the 13 bucketized cont fields exist but are unused
        # (the linear branch uses the raw log-scaled values instead,
        # xdeepfm/xdeepfm.py:82).
        params = base.init_fused(ks[0])
        params["lin_dense"] = nn.dense_init(ks[1], n_cont, 1)
        params["cin"] = interactions.cin_init(ks[3], base.num_fields,
                                              cfg.cin_layers)
        params["cin_out"] = nn.dense_init(ks[4], sum(cfg.cin_layers), 1)
        mlp_p, mlp_s = nn.mlp_init(ks[5], flat_dim, cfg.deep_layers, cfg.use_bn)
        params["dnn"] = mlp_p
        params["dnn_out"] = nn.dense_init(ks[6], cfg.deep_layers[-1], 1)
        k_final = jax.random.fold_in(key, 7)
        params["final"] = _final_dense_init(k_final, 3)
        return params, {"dnn": mlp_s}

    # engine-order positions of the 26 categorical fields (original index
    # ≥ n_cont) — static subset of parts.wide, no data reordering
    cat_pos = np.where(base.engine.field_order >= n_cont)[0].astype(np.int32)

    def apply(params, state, batch, *, train=False, rng=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        lin = (
            nn.dense(params["lin_dense"], batch["dense"])
            + jnp.sum(jnp.take(parts.wide, jnp.asarray(cat_pos), axis=1),
                      axis=1, keepdims=True)
        )
        linear_y = jax.nn.relu(lin)
        # CIN consumes the 3-D field-map form; engine field order is a
        # static permutation the CIN weights absorb at init
        emb = parts.emb_3d(base.num_fields, cfg.embedding_dim)
        cin_pool = interactions.cin_apply_xla(params["cin"], emb)
        cin_y = nn.dense(params["cin_out"], cin_pool, activation=jax.nn.relu)

        h, dnn_s = nn.mlp_apply(
            params["dnn"], state["dnn"], parts.emb_2d,
            train=train, dropout_rate=cfg.dropout, rng=rng,
        )
        dnn_y = nn.dense(params["dnn_out"], h, activation=jax.nn.relu)

        logits = nn.dense(
            params["final"], jnp.concatenate([linear_y, cin_y, dnn_y], -1)
        )
        return _squeeze_logits(logits), {"dnn": dnn_s}

    return Model("xdeepfm", init, apply, meta=base.meta)


# ---------------------------------------------------------------------------
# DNN baseline — dnn/ has no code; README.md:68-78 describes raw-embedding +
# 100,100 tower. Same tower defaults as the other Criteo models.
# ---------------------------------------------------------------------------

@register("dnn")
def make_dnn(criteo: CriteoConfig = CriteoConfig(),
             cfg: ModelConfig = ModelConfig(name="dnn")) -> Model:
    base = _CriteoBase(criteo, cfg)
    flat_dim = base.num_fields * cfg.embedding_dim

    def init(key):
        k1, k2, k3 = jax.random.split(key, 3)
        params = base.init_fused(k1)
        mlp_p, mlp_s = nn.mlp_init(k2, flat_dim, cfg.deep_layers, cfg.use_bn)
        params["dnn"] = mlp_p
        params["final"] = nn.dense_init(k3, cfg.deep_layers[-1], 1)
        return params, {"dnn": mlp_s}

    def apply(params, state, batch, *, train=False, rng=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        mlp_in = parts.emb_parts if parts.emb_parts is not None \
            else parts.emb_2d
        h, dnn_s = nn.mlp_apply(
            params["dnn"], state["dnn"], mlp_in,
            train=train, dropout_rate=cfg.dropout, rng=rng,
        )
        logits = nn.dense(params["final"], h)
        return _squeeze_logits(logits), {"dnn": dnn_s}

    return Model("dnn", init, apply, meta=base.meta)


# ---------------------------------------------------------------------------
# WideLinear — deep&wide/deep&wide.py:114-149 (canned LinearClassifier on
# linear columns only; the "deep" part is never built in the reference).
# ---------------------------------------------------------------------------

@register("wide")
def make_wide(criteo: CriteoConfig = CriteoConfig(),
              cfg: ModelConfig = ModelConfig(name="wide")) -> Model:
    base = _CriteoBase(criteo, cfg)

    def init(key):
        return {"wide": emb_table.linear_init(key, criteo.field_vocab_sizes)}, {}

    def apply(params, state, batch, *, train=False, rng=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        gids = base.gids(batch)
        logits = emb_ops.linear(params["wide"], gids)
        return _squeeze_logits(logits), state

    # LinearClassifier is FTRL-backed in the reference
    # (deep&wide/deep&wide.py:146-149) — train/optim.for_model honors this.
    return Model("wide", init, apply, meta=dict(base.meta, optimizer="ftrl"))
