"""Packed-table gathers and their scatter-add gradients vs a float64 NumPy
oracle, for the three storage layouts (row-major, flat, W-major), plus the
engine pieces built on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys.core.config import CriteoConfig, EmbeddingConfig
from recsys.embeddings import engines
from recsys.embeddings import table as T


def _oracle_grad(ids, g, num_rows):
    out = np.zeros((num_rows, g.shape[-1]), np.float64)
    np.add.at(out, ids.reshape(-1), g.reshape(-1, g.shape[-1]))
    return out


def _gather(layout, table, ids):
    """Rows [..., W] of the [V, W] ``table`` stored in ``layout``, and the
    function of the stored array that produces them."""
    v, w = table.shape
    if layout == "row":
        return jnp.asarray(table), lambda t: T.table_gather(t, ids)
    if layout == "flat":
        return (jnp.asarray(table.reshape(-1)),
                lambda t: T.table_gather_flat(t, ids, v, w))
    return (jnp.asarray(table.T),
            lambda t: T.table_gather_wm(t, ids.reshape(-1)).reshape(
                *ids.shape, w))


def _as_rows(layout, grad, v, w):
    grad = np.asarray(grad)
    if layout == "flat":
        return grad.reshape(v, w)
    return grad.T if layout == "wm" else grad


LAYOUTS = ["row", "flat", "wm"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n,w,v", [
    (1024, 17, 2048),          # aligned
    (1000, 16, 1000),          # ragged rows + ragged N
    (4096, 8, 512),            # many duplicates (N >> V)
    (64, 17, 4096),            # sparse touch (N << V)
])
def test_gather_grad_matches_oracle(layout, n, w, v, rng):
    table = rng.standard_normal((v, w)).astype(np.float32)
    ids = rng.integers(0, v, size=n).astype(np.int32)
    ct = rng.standard_normal((n, w)).astype(np.float32)
    stored, fn = _gather(layout, table, jnp.asarray(ids))
    rows, vjp = jax.vjp(fn, stored)
    np.testing.assert_array_equal(np.asarray(rows), table[ids])
    got = _as_rows(layout, vjp(jnp.asarray(ct))[0], v, w)
    np.testing.assert_allclose(got, _oracle_grad(ids, ct, v),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gather_grad_2d_ids(layout, rng):
    b, f, w, v = 64, 39, 17, 4096
    table = rng.standard_normal((v, w)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, f)).astype(np.int32)
    ct = rng.standard_normal((b, f, w)).astype(np.float32)
    stored, fn = _gather(layout, table, jnp.asarray(ids))
    rows, vjp = jax.vjp(fn, stored)
    assert rows.shape == (b, f, w)
    np.testing.assert_array_equal(np.asarray(rows), table[ids])
    got = _as_rows(layout, vjp(jnp.asarray(ct))[0], v, w)
    np.testing.assert_allclose(got, _oracle_grad(ids, ct, v),
                               rtol=1e-5, atol=1e-5)


def test_gather_grad_jit_and_in_scan(rng):
    """The gradient must survive jit + lax.scan (the fast training path)."""
    v, w, n, k = 512, 8, 256, 3
    ids = rng.integers(0, v, size=(k, n)).astype(np.int32)
    ct = rng.standard_normal((k, n, w)).astype(np.float32)

    @jax.jit
    def run(ids, ct):
        def body(acc, xs):
            i, c = xs
            _, vjp = jax.vjp(lambda t: T.table_gather_wm(t, i),
                             jnp.zeros((w, v)))
            return acc + vjp(c)[0], 0
        acc, _ = jax.lax.scan(body, jnp.zeros((w, v)), (ids, ct))
        return acc

    got = np.asarray(run(jnp.asarray(ids), jnp.asarray(ct))).T
    want = sum(_oracle_grad(ids[i], ct[i], v) for i in range(k))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_pad_rows_unchanged():
    """Table shapes (and with them initial values and checkpoints) keep
    the 1024-row padding."""
    assert T.ROW_PAD == 1024
    assert [T.pad_rows(n) for n in (1, 1023, 1024, 1025, 5000)] == [
        1024, 1024, 1024, 2048, 5120]
    cfg = CriteoConfig()
    assert T.pad_rows(cfg.total_vocab) == 840_704
    big = sum(v for v in cfg.field_vocab_sizes
              if v > engines.SPLIT_THRESHOLD)
    assert T.pad_rows(big) == 837_632


def _stacked_identity_sums(x2d, f, d):
    """The former matmul form of `_field_sums` (identity blocks stacked)."""
    s_mat = jnp.tile(jnp.eye(d, dtype=x2d.dtype), (f, 1))
    hi = jax.lax.Precision.HIGHEST
    return (jnp.dot(x2d, s_mat, precision=hi),
            jnp.dot(jnp.square(x2d), s_mat, precision=hi))


def test_field_sums_match_matmul_form(rng):
    b, f, d = 32, 14, 16
    x2d = jnp.asarray(rng.standard_normal((b, f * d)).astype(np.float32))
    got = engines._field_sums(x2d, f, d)
    want = _stacked_identity_sums(x2d, f, d)
    for g, wnt in zip(got, want):
        assert g.shape == (b, d) and g.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(g), np.asarray(wnt),
                                   rtol=1e-6, atol=1e-6)


def test_big_parts_match_selector_form(rng):
    """Slicing the W-major rows gives what the former selector matmul
    gave: per-field embeddings [B, Fb·D] and wide weights [B, Fb]."""
    vocabs = (3000, 2500, 40)
    eng = engines.SplitEngine(EmbeddingConfig(field_vocab_sizes=vocabs,
                                              embedding_dim=8))
    params = eng.init(jax.random.key(0))
    ids = jnp.asarray(np.stack([rng.integers(0, v, 16) for v in vocabs],
                               axis=1).astype(np.int32))
    _, big = eng._partition()
    emb2, wide = eng._big_parts(params, ids, big)

    d, w, fb = 8, eng.width, len(big)
    rows = np.asarray(T.table_gather_wm(
        params["big_wm"], eng._big_gids(ids, big).reshape(-1)))
    sel = np.zeros((fb * w, fb * d + fb), np.float32)
    for f in range(fb):
        sel[f * w:f * w + d, f * d:(f + 1) * d] = np.eye(d)
        sel[f * w + d, fb * d + f] = 1.0
    want = rows.reshape(16, fb * w) @ sel
    np.testing.assert_array_equal(np.asarray(emb2), want[:, :fb * d])
    np.testing.assert_array_equal(np.asarray(wide), want[:, fb * d:])
