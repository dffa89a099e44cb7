"""Interaction ops: FM pairwise, DCN cross, CIN, DIN attention.

Plain XLA formulations of the four interaction towers in the reference
model zoo, each written as a few matmuls and fused elementwise ops.

Shapes use B=batch, F=num fields, D=embedding dim, H=CIN feature maps,
P=padded history length, K=embedding dim (DIN).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from recsys.ops import nn


# ---------------------------------------------------------------------------
# FM second-order term (fm/fm.py:124-129, deepfm/deepfm.py:92-98)
# ---------------------------------------------------------------------------

def fm_pairwise(emb: jax.Array) -> jax.Array:
    """0.5 * Σ_d [(Σ_f e_fd)² − Σ_f e_fd²]  →  [B, 1].

    The sum-square minus square-sum identity computes all O(F²) pairwise
    embedding interactions in O(F·D). Elementwise work that XLA fuses into
    the surrounding graph.
    """
    sum_sq = jnp.square(jnp.sum(emb, axis=1))          # [B, D]
    sq_sum = jnp.sum(jnp.square(emb), axis=1)          # [B, D]
    return 0.5 * jnp.sum(sum_sq - sq_sum, axis=1, keepdims=True)


def fm_pairwise_from_sums(emb_sum: jax.Array,
                          emb_sq_sum: jax.Array) -> jax.Array:
    """`fm_pairwise` from pre-reduced per-batch field sums ([B, D] Σ_f e_f
    and Σ_f e_f²) — what the parts-based embedding engines hand out so the
    [B, F, D] tensor never materializes (embeddings/engines.py EmbParts)."""
    return 0.5 * jnp.sum(jnp.square(emb_sum) - emb_sq_sum, axis=1,
                         keepdims=True)


# ---------------------------------------------------------------------------
# DCN cross layers (dcn/dcn.py:132-142)
# ---------------------------------------------------------------------------

def cross_init(key, dim: int, num_layers: int, dtype=jnp.float32):
    """Per-layer rank-1 weight and bias, both glorot_normal as in the
    reference (dcn/dcn.py:137-139 — yes, the bias too)."""
    params = []
    for _ in range(num_layers):
        key, kw, kb = jax.random.split(key, 3)
        params.append({
            "w": nn.glorot_normal(kw, (dim,), dtype),
            "b": nn.glorot_normal(kb, (dim,), dtype),
        })
    return params


def cross_apply(params, x0: jax.Array) -> jax.Array:
    """x_{l+1} = x0 · (x_l ⊤ w_l) + x_l + b_l  over [B, dim].

    Each layer is one [B,dim]×[dim] contraction + fused elementwise ops —
    memory-bound, so the whole stack fuses into a few elementwise passes.
    """
    xl = x0
    for layer in params:
        xw = jnp.einsum("bd,d->b", xl, layer["w"])       # [B]
        xl = xw[:, None] * x0 + xl + layer["b"]
    return xl


# ---------------------------------------------------------------------------
# CIN — compressed interaction network (xdeepfm/xdeepfm.py:135-182)
# ---------------------------------------------------------------------------

def cin_init(key, num_fields: int, layer_sizes: tuple[int, ...],
             dtype=jnp.float32):
    """Filters W_k of shape [F_{k-1}·F_0, H_k] (the conv1d filters at
    xdeepfm/xdeepfm.py:154-156) + bias, zeros-init bias as the reference."""
    params = []
    f0 = num_fields
    fk = num_fields
    for h in layer_sizes:
        key, sub = jax.random.split(key)
        params.append({
            # conv1d filter [1, Fk*F0, H] — glorot_uniform (tf get_variable
            # default for conv-like shapes is glorot_uniform)
            "w": nn.glorot_uniform(sub, (fk * f0, h), dtype),
            "b": jnp.zeros((h,), dtype),
        })
        fk = h
    return params


def cin_apply_xla(params, x0: jax.Array) -> jax.Array:
    """CIN forward → pooled feature map concat, shape [B, Σ_k H_k].

    The reference realizes each layer as D embedding-dim splits + batched
    matmul + conv1d (xdeepfm/xdeepfm.py:145-158). Here it collapses to a
    single matmul chain per layer:

        z_k[(b,d), p·F_k+q] = x0[b,p,d] · x_k[(b,d), q]
        x_{k+1}[(b,d), h]   = relu( z_k @ W_k + b_h )

    i.e. one [B·D, F0·Fk] × [F0·Fk, H] matmul per layer.
    Layout note: every feature map is carried as [B·D, F] (embedding dim
    fused into rows, fields minor) so the z outer product is a pure
    broadcast-multiply and its [B·D, F0·Fk] reshape is free in row-major,
    with one transpose at entry instead of one per layer on z and its
    cotangent.
    Direct-connect: every layer's output sum-pooled over D and concatenated
    (xdeepfm/xdeepfm.py:172-181).
    """
    b, f0, d = x0.shape
    x0v = x0.transpose(0, 2, 1).reshape(b * d, f0)   # one transpose at entry
    xkv = x0v
    pooled = []
    for layer in params:
        fk = xkv.shape[-1]
        # index p*Fk+q matches the reference's reshape of
        # matmul(split0, split_k^T).
        z = (x0v[:, :, None] * xkv[:, None, :]).reshape(b * d, f0 * fk)
        out = jnp.dot(z, layer["w"], preferred_element_type=jnp.float32)
        h = jax.nn.relu(out + layer["b"])            # [B·D, H] f32
        pooled.append(jnp.sum(h.reshape(b, d, -1), axis=1))     # [B, H]
        xkv = h.astype(x0.dtype)
    return jnp.concatenate(pooled, axis=1).astype(x0.dtype)


# ---------------------------------------------------------------------------
# DIN target attention (din/din.py:103-125)
# ---------------------------------------------------------------------------

def din_attention_init(key, emb_dim: int, attention_layers: tuple[int, ...],
                       dtype=jnp.float32):
    params = {"mlp": [], "out": None}
    d = 4 * emb_dim  # [hist, query, hist*query, hist-query]
    for h in attention_layers:
        key, sub = jax.random.split(key)
        params["mlp"].append(nn.dense_init(sub, d, h, dtype))
        d = h
    key, sub = jax.random.split(key)
    params["out"] = nn.dense_init(sub, d, 1, dtype)
    return params


def din_attention(
    params,
    hist_emb: jax.Array,    # [B, P, K] history embeddings
    hist_ids: jax.Array,    # [B, P] padded ids (0 = padding, din/din.py:107)
    query_emb: jax.Array,   # [B, K] target item embedding
    *,
    train: bool = False,
    dropout_rate: float = 0.0,
    rng: jax.Array | None = None,
) -> jax.Array:
    """Per-position attention MLP over [hist, query, hist⊙query, hist−query],
    then masked weighted-sum pooling → [B, K].

    The history axis is statically padded (padding buckets chosen by the
    loader); masking by ``id > 0`` reproduces din/din.py:107. The MLP runs
    on the flattened [B·P, 4K] batch — one big matmul instead of the
    reference's per-batch dynamic shapes.
    """
    b, p, k = hist_emb.shape
    query = jnp.broadcast_to(query_emb[:, None, :], (b, p, k))
    att_in = jnp.concatenate(
        [hist_emb, query, hist_emb * query, hist_emb - query], axis=-1
    ).reshape(b * p, 4 * k)
    h = att_in
    for layer in params["mlp"]:
        h = nn.dense(layer, h, activation=jax.nn.relu)
        if dropout_rate > 0.0 and train:
            assert rng is not None
            rng, sub = jax.random.split(rng)
            h = nn.dropout(sub, h, dropout_rate, train)
    wgt = nn.dense(params["out"], h).reshape(b, p, 1)
    mask = (hist_ids > 0).astype(hist_emb.dtype)[:, :, None]
    return jnp.sum(hist_emb * wgt * mask, axis=1)
