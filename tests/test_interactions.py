"""Interaction ops vs O(n²)/loop numpy oracles (SURVEY §4a).

Each oracle re-derives the math the way the reference computes it
(per-pair loops / split+matmul+conv1d), independently of the vectorized
implementation under test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys.ops import interactions, nn


def test_fm_pairwise_matches_pairwise_loop(rng):
    b, f, d = 4, 7, 5
    emb = rng.normal(size=(b, f, d)).astype(np.float32)
    # oracle: Σ_{i<j} <e_i, e_j>  (the FM 2nd-order term)
    oracle = np.zeros((b, 1), np.float32)
    for i in range(f):
        for j in range(i + 1, f):
            oracle[:, 0] += np.sum(emb[:, i] * emb[:, j], axis=1)
    got = np.asarray(interactions.fm_pairwise(jnp.asarray(emb)))
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


def test_cross_layer_matches_loop(rng):
    b, dim, L = 3, 6, 4
    x0 = rng.normal(size=(b, dim)).astype(np.float32)
    params = interactions.cross_init(jax.random.key(0), dim, L)
    # oracle: x_{l+1}[b] = x0[b] * (x_l[b]·w) + x_l[b] + bias
    xl = x0.copy()
    for layer in params:
        w = np.asarray(layer["w"])
        bias = np.asarray(layer["b"])
        for i in range(b):
            xw = float(xl[i] @ w)
            xl[i] = x0[i] * xw + xl[i] + bias
    got = np.asarray(interactions.cross_apply(params, jnp.asarray(x0)))
    np.testing.assert_allclose(got, xl, rtol=1e-4, atol=1e-4)


def test_cin_matches_reference_split_matmul_conv(rng):
    """Oracle mirrors xdeepfm/xdeepfm.py:145-181: per-embedding-dim outer
    product (split+matmul), 'conv1d' = matmul with [Fk*F0, H] filters where
    the flat index is p*Fk+q, relu, then sum-pool over D."""
    b, f0, d = 3, 5, 4
    layer_sizes = (6, 3)
    x0 = rng.normal(size=(b, f0, d)).astype(np.float32)
    params = interactions.cin_init(jax.random.key(1), f0, layer_sizes)

    xk = x0.copy()
    pooled = []
    for li, h in enumerate(layer_sizes):
        fk = xk.shape[1]
        w = np.asarray(params[li]["w"])          # [F0*Fk, H]
        bias = np.asarray(params[li]["b"])
        nxt = np.zeros((b, h, d), np.float32)
        for bi in range(b):
            for di in range(d):
                # outer product slice: [F0, Fk], flattened p*Fk+q
                outer = np.outer(x0[bi, :, di], xk[bi, :, di]).reshape(-1)
                nxt[bi, :, di] = np.maximum(outer @ w + bias, 0.0)
        xk = nxt
        pooled.append(nxt.sum(axis=2))
    oracle = np.concatenate(pooled, axis=1)

    got = np.asarray(interactions.cin_apply_xla(params, jnp.asarray(x0)))
    np.testing.assert_allclose(got, oracle, rtol=1e-3, atol=1e-3)


def test_din_attention_matches_loop(rng):
    b, p, k = 3, 6, 4
    hist = rng.normal(size=(b, p, k)).astype(np.float32)
    ids = rng.integers(0, 3, size=(b, p)).astype(np.int32)  # some zeros=pad
    query = rng.normal(size=(b, k)).astype(np.float32)
    params = interactions.din_attention_init(jax.random.key(2), k, (8, 4))

    def dense_np(lp, x):
        return x @ np.asarray(lp["w"]) + np.asarray(lp["b"])

    oracle = np.zeros((b, k), np.float32)
    for bi in range(b):
        for pi in range(p):
            h = np.concatenate([
                hist[bi, pi], query[bi], hist[bi, pi] * query[bi],
                hist[bi, pi] - query[bi],
            ])[None, :]
            for lp in params["mlp"]:
                h = np.maximum(dense_np(lp, h), 0.0)
            wgt = dense_np(params["out"], h)[0, 0]
            if ids[bi, pi] > 0:
                oracle[bi] += hist[bi, pi] * wgt

    got = np.asarray(
        interactions.din_attention(
            params, jnp.asarray(hist), jnp.asarray(ids), jnp.asarray(query)
        )
    )
    np.testing.assert_allclose(got, oracle, rtol=1e-3, atol=1e-3)


def test_mlp_bn_dropout_shapes_and_state(rng):
    x = rng.normal(size=(16, 10)).astype(np.float32)
    params, state = nn.mlp_init(jax.random.key(0), 10, (8, 4), use_bn=True)
    y, new_state = nn.mlp_apply(
        params, state, jnp.asarray(x), train=True, dropout_rate=0.5,
        rng=jax.random.key(1),
    )
    assert y.shape == (16, 4)
    # BN moving stats must move in train mode (the reference's TF1 bug left
    # them frozen; we assert the fix).
    assert not np.allclose(
        np.asarray(new_state["layers"][0]["bn"]["mean"]),
        np.asarray(state["layers"][0]["bn"]["mean"]),
    )
    # eval mode: deterministic, state unchanged
    y1, s1 = nn.mlp_apply(params, state, jnp.asarray(x), train=False)
    y2, _ = nn.mlp_apply(params, state, jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2))
    assert np.allclose(
        np.asarray(s1["layers"][0]["bn"]["mean"]),
        np.asarray(state["layers"][0]["bn"]["mean"]),
    )


def _cin_conv_reference(params, x0):
    """The split-matmul/conv formulation of the test above in jnp: per
    embedding dim the [F0, Fk] outer product, 'conv1d' = matmul with
    [F0·Fk, H] filters, relu, sum-pool over D."""
    b, f0, d = x0.shape
    xk = x0
    pooled = []
    for layer in params:
        z = jnp.einsum("bpd,bqd->bdpq", x0, xk).reshape(b, d, -1)
        xk = jax.nn.relu(jnp.einsum("bdk,kh->bhd", z, layer["w"])
                         + layer["b"][None, :, None])
        pooled.append(jnp.sum(xk, axis=2))
    return jnp.concatenate(pooled, axis=1)


@pytest.mark.parametrize("layer_sizes", [(4,), (5, 3), (20, 10, 10)])
def test_cin_xla_matches_conv_reference(layer_sizes):
    b, f0, d = 24, 7, 8
    params = interactions.cin_init(jax.random.key(0), f0, layer_sizes)
    x0 = jax.random.normal(jax.random.key(1), (b, f0, d), jnp.float32)
    got = interactions.cin_apply_xla(params, x0)
    want = _cin_conv_reference(params, x0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_cin_xla_grads_match_conv_reference():
    b, f0, d = 16, 6, 4
    layer_sizes = (5, 3)
    params = interactions.cin_init(jax.random.key(2), f0, layer_sizes)
    x0 = jax.random.normal(jax.random.key(3), (b, f0, d), jnp.float32)
    # a scalar loss touching every output element unevenly
    w_out = jax.random.normal(jax.random.key(4), (sum(layer_sizes),))

    def loss(fn):
        return lambda p, x: jnp.sum(fn(p, x) * w_out)

    gp, gx = jax.grad(loss(interactions.cin_apply_xla), (0, 1))(params, x0)
    rp, rx = jax.grad(loss(_cin_conv_reference), (0, 1))(params, x0)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(rx),
                               rtol=1e-4, atol=1e-5)
    for got, want in zip(gp, rp):
        for k in ("w", "b"):
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-5)


def test_cin_xla_preserves_bf16_dtype():
    """bf16 primals keep their dtype through forward AND grad."""
    params = interactions.cin_init(jax.random.key(3), 6, (4, 3))
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
    x0 = jax.random.normal(jax.random.key(4), (8, 6, 4), jnp.bfloat16)
    out = interactions.cin_apply_xla(params, x0)
    assert out.dtype == jnp.bfloat16

    def loss(p, x):
        return jnp.sum(interactions.cin_apply_xla(p, x).astype(jnp.float32))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x0)
    assert gx.dtype == jnp.bfloat16
    for layer in gp:
        assert layer["w"].dtype == jnp.bfloat16
        assert layer["b"].dtype == jnp.bfloat16
