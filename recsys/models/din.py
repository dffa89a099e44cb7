"""DIN — Deep Interest Network with target attention (din/din.py:83-180).

Batch layout (produced by `recsys.data.amazon`):
    {'i_id': int32 [B], 'i_cate': int32 [B],
     'hist_iid': int32 [B, P], 'hist_cate': int32 [B, P],
     'label': float32 [B]}
with P a *static* padded history length (one compiled step — the reference's
VarLenFeature densification at din/din.py:48-57 becomes bucketed fixed-length
padding in the loader; id 0 is padding, masked per din/din.py:107).

Parity map:
- item bias table [63002] zero-init (din/din.py:88), added to the final
  logits (din/din.py:139);
- item/category embedding tables glorot_normal (din/din.py:89-90);
- per-position attention MLP (80,40→1) over
  [hist, query, hist⊙query, hist−query] with dropout (din/din.py:114-121),
  masked weighted-sum pooling (din/din.py:122-124);
- top MLP (100,50,20) over concat(item_emb, item_att, cate_att)
  (din/din.py:130-138) — the reference hardcodes these sizes in model_fn,
  shadowing its own flags.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from recsys.core.config import ModelConfig
from recsys.models.api import Model, register
from recsys.ops import interactions, nn

ITEM_VOCAB = 63002   # din/din.py:88-89
CATE_VOCAB = 802     # din/din.py:90


@register("din")
def make_din(item_vocab: int = ITEM_VOCAB, cate_vocab: int = CATE_VOCAB,
             cfg: ModelConfig = ModelConfig(name="din", embedding_dim=32,
                                            use_bn=False)) -> Model:
    d = cfg.embedding_dim

    def init(key):
        ks = jax.random.split(key, 6)
        params = {
            "item_bias": jnp.zeros((item_vocab,), jnp.float32),
            "item_emb": nn.glorot_normal(ks[0], (item_vocab, d)),
            "cate_emb": nn.glorot_normal(ks[1], (cate_vocab, d)),
            "att_item": interactions.din_attention_init(
                ks[2], d, cfg.attention_layers),
            "att_cate": interactions.din_attention_init(
                ks[3], d, cfg.attention_layers),
        }
        mlp_p, mlp_s = nn.mlp_init(ks[4], 3 * d, cfg.mlp_layers, use_bn=False)
        params["mlp"] = mlp_p
        params["final"] = nn.dense_init(ks[5], cfg.mlp_layers[-1], 1)
        return params, {"mlp": mlp_s}

    def apply(params, state, batch, *, train=False, rng=None, emb_ops=None):
        del emb_ops  # DIN's tables are small; always local
        from recsys.embeddings import table as emb_table

        # the backward of each gather is one scatter-add into its table
        item_emb = emb_table.table_gather(params["item_emb"], batch["i_id"])
        cate_emb = emb_table.table_gather(params["cate_emb"], batch["i_cate"])
        hist_item = emb_table.table_gather(params["item_emb"],
                                           batch["hist_iid"])
        hist_cate = emb_table.table_gather(params["cate_emb"],
                                           batch["hist_cate"])

        if rng is not None:
            rng, r1, r2, r3 = jax.random.split(rng, 4)
        else:
            r1 = r2 = r3 = None
        att_item = interactions.din_attention(
            params["att_item"], hist_item, batch["hist_iid"], item_emb,
            train=train, dropout_rate=cfg.dropout, rng=r1)
        att_cate = interactions.din_attention(
            params["att_cate"], hist_cate, batch["hist_cate"], cate_emb,
            train=train, dropout_rate=cfg.dropout, rng=r2)

        net = jnp.concatenate([item_emb, att_item, att_cate], axis=1)
        h, mlp_s = nn.mlp_apply(
            params["mlp"], state["mlp"], net,
            train=train, dropout_rate=cfg.dropout, rng=r3)
        logits = nn.dense(params["final"], h)[:, 0]
        logits = logits + jnp.take(params["item_bias"], batch["i_id"], axis=0)
        return logits, {"mlp": mlp_s}

    def sample_features(n: int, hist_len: int = 32) -> dict:
        """Synthetic serving/warmup features (serve.export.Servable); the
        padded history length is one of the loader's static buckets
        (data/amazon.py) — requests with other lengths compile new buckets."""
        import numpy as np

        rng = np.random.default_rng(0)
        return {
            "i_id": rng.integers(1, item_vocab, n).astype(np.int32),
            "i_cate": rng.integers(1, cate_vocab, n).astype(np.int32),
            "hist_iid": rng.integers(0, item_vocab, (n, hist_len)).astype(
                np.int32),
            "hist_cate": rng.integers(0, cate_vocab, (n, hist_len)).astype(
                np.int32),
        }

    return Model("din", init, apply,
                 meta={"sample_features": sample_features})
