"""Embedding subsystem: packing, sharded-vs-local equivalence (SURVEY §4e)."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from recsys.core.mesh import make_virtual_mesh
from recsys.embeddings import table as T
from recsys.parallel import sharded_embedding as SE


def test_field_offsets_and_global_ids():
    vocabs = (3, 5, 2)
    off = T.field_offsets(vocabs)
    np.testing.assert_array_equal(off, [0, 3, 8])
    ids = jnp.asarray([[0, 4, 1], [2, 0, 0]], jnp.int32)
    gids = T.to_global_ids(ids, off)
    np.testing.assert_array_equal(np.asarray(gids), [[0, 7, 9], [2, 3, 8]])


def test_lookup_and_linear_shapes(rng):
    from recsys.core.config import EmbeddingConfig
    vocabs = (10, 20, 30)
    cfg = EmbeddingConfig(field_vocab_sizes=vocabs, embedding_dim=8)
    params = T.embedding_init(jax.random.key(0), cfg)
    lin = T.linear_init(jax.random.key(1), vocabs)
    ids = jnp.asarray(rng.integers(0, 10, (4, 3)), jnp.int32)
    gids = T.to_global_ids(ids, T.field_offsets(vocabs))
    emb = T.embedding_lookup(params, gids)
    assert emb.shape == (4, 3, 8)
    y = T.linear_sum(lin, gids)
    assert y.shape == (4, 1)
    # oracle
    wt = np.asarray(lin["w"])
    expect = wt[np.asarray(gids)].sum(axis=1, keepdims=True) + float(lin["b"])
    np.testing.assert_allclose(np.asarray(y), expect, rtol=1e-6)


def test_sharded_lookup_matches_local(rng):
    """Row-sharded masked-gather+psum == plain gather, fwd and bwd."""
    env = make_virtual_mesh(8, model_axis=4)  # 2 data x 4 model
    v, d, b, f = 64, 16, 8, 5
    table = jnp.asarray(rng.normal(size=(v, d)), jnp.float32)
    gids = jnp.asarray(rng.integers(0, v, (b, f)), jnp.int32)

    def sharded_fn(tbl, ids):
        emb = SE.psum_embedding_lookup(tbl, ids, "model")
        # local batch shard → global loss needs the data-axis psum
        return jax.lax.psum(jnp.sum(emb ** 2), "data"), emb

    fn = shard_map(
        sharded_fn, mesh=env.mesh,
        in_specs=(P("model", None), P("data", None)),
        out_specs=(P(), P("data", None, None)),
        check_vma=False,
    )
    loss_sharded, emb_sharded = fn(table, gids)
    emb_local = jnp.take(table, gids, axis=0)
    np.testing.assert_allclose(
        np.asarray(emb_sharded), np.asarray(emb_local), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        float(loss_sharded), float(jnp.sum(emb_local ** 2)), rtol=1e-5
    )

    # gradient equivalence (scatter-add path)
    def loss_sharded_only(tbl):
        return fn(tbl, gids)[0]

    g_sharded = jax.grad(loss_sharded_only)(table)
    g_local = jax.grad(lambda t: jnp.sum(jnp.take(t, gids, axis=0) ** 2))(table)
    np.testing.assert_allclose(
        np.asarray(g_sharded), np.asarray(g_local), rtol=1e-5, atol=1e-6
    )


def test_sharded_linear_matches_local(rng):
    env = make_virtual_mesh(8, model_axis=4)
    v, b, f = 64, 8, 5
    w = jnp.asarray(rng.normal(size=(v,)), jnp.float32)
    bias = jnp.asarray(0.5, jnp.float32)
    gids = jnp.asarray(rng.integers(0, v, (b, f)), jnp.int32)

    fn = shard_map(
        lambda wv, ids: SE.sharded_linear_sum(wv, bias, ids, "model"),
        mesh=env.mesh,
        in_specs=(P("model"), P("data", None)),
        out_specs=P("data", None),
        check_vma=False,
    )
    got = fn(w, gids)
    expect = jnp.sum(jnp.take(w, gids, axis=0), axis=1, keepdims=True) + bias
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), rtol=1e-5)


def _a2a_roundtrip(rng, v, d, b, f, model_axis, exact, cap_factor=2.0,
                   duplicate_heavy=False):
    env = make_virtual_mesh(8, model_axis=model_axis)
    table = jnp.asarray(rng.normal(size=(v, d)), jnp.float32)
    hi = 4 if duplicate_heavy else v
    gids = jnp.asarray(rng.integers(0, hi, (b, f)), jnp.int32)

    def sharded_fn(tbl, ids):
        emb = SE.a2a_embedding_lookup(tbl, ids, "model", exact=exact,
                                      cap_factor=cap_factor)
        return jax.lax.psum(jnp.sum(emb ** 2), "data"), emb

    fn = shard_map(
        sharded_fn, mesh=env.mesh,
        in_specs=(P("model", None), P("data", None)),
        out_specs=(P(), P("data", None, None)),
        check_vma=False,
    )
    return fn, table, gids


def test_a2a_lookup_matches_local(rng):
    """Dedup + all-to-all lookup == plain gather, fwd and bwd (exact caps)."""
    fn, table, gids = _a2a_roundtrip(rng, v=64, d=16, b=8, f=5,
                                     model_axis=4, exact=True)
    loss_sharded, emb_sharded = fn(table, gids)
    emb_local = jnp.take(table, gids, axis=0)
    np.testing.assert_allclose(np.asarray(emb_sharded), np.asarray(emb_local),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss_sharded),
                               float(jnp.sum(emb_local ** 2)), rtol=1e-5)

    g_sharded = jax.grad(lambda t: fn(t, gids)[0])(table)
    g_local = jax.grad(lambda t: jnp.sum(jnp.take(t, gids, axis=0) ** 2))(table)
    np.testing.assert_allclose(np.asarray(g_sharded), np.asarray(g_local),
                               rtol=1e-5, atol=1e-6)


def test_a2a_lookup_duplicate_heavy(rng):
    """Heavy duplication: dedup collapses wire rows; still exact, and the
    capacity-factor path is lossless because unique counts are tiny."""
    fn, table, gids = _a2a_roundtrip(rng, v=64, d=8, b=16, f=5,
                                     model_axis=2, exact=False,
                                     cap_factor=2.0, duplicate_heavy=True)
    _, emb_sharded = fn(table, gids)
    emb_local = jnp.take(table, gids, axis=0)
    np.testing.assert_allclose(np.asarray(emb_sharded), np.asarray(emb_local),
                               rtol=1e-5, atol=1e-6)
    g_sharded = jax.grad(lambda t: fn(t, gids)[0])(table)
    g_local = jax.grad(lambda t: jnp.sum(jnp.take(t, gids, axis=0) ** 2))(table)
    np.testing.assert_allclose(np.asarray(g_sharded), np.asarray(g_local),
                               rtol=1e-5, atol=1e-6)


def test_a2a_model_axis_one(rng):
    """Degenerate model axis (no sharding) must reduce to the local gather."""
    fn, table, gids = _a2a_roundtrip(rng, v=32, d=4, b=8, f=3,
                                     model_axis=1, exact=True)
    _, emb_sharded = fn(table, gids)
    np.testing.assert_allclose(np.asarray(emb_sharded),
                               np.asarray(jnp.take(table, gids, axis=0)),
                               rtol=1e-5, atol=1e-6)


def test_a2a_overflow_diagnostic(rng):
    """a2a_overflow counts capacity overflows; 0 at exact-equivalent caps."""
    gids = rng.integers(0, 64, (8, 5)).astype(np.int32)
    assert SE.a2a_overflow(gids, num_shards=4, shard_rows=16,
                           cap_factor=4.0) == 0
    # pathological skew: every id owned by shard 0, tiny capacity
    skew = np.zeros((8, 5), np.int32)
    assert SE.a2a_overflow(skew, num_shards=4, shard_rows=16,
                           cap_factor=0.04) >= 0


def test_split_engine_infer_gather_matches_train_matmul():
    """SplitEngine.lookup(train=False) (plain gather) must equal the
    training-path one-hot matmul exactly (same table rows either way)."""
    import jax
    import numpy as np
    from recsys.core.config import EmbeddingConfig
    from recsys.embeddings.engines import SplitEngine

    cfg = EmbeddingConfig(field_vocab_sizes=(7, 3000, 50, 11), embedding_dim=8)
    eng = SplitEngine(cfg, threshold=64)
    params = eng.init(jax.random.key(0))
    rng = np.random.default_rng(1)
    ids = np.stack([rng.integers(0, v, 32) for v in cfg.field_vocab_sizes],
                   axis=1).astype(np.int32)
    emb_t, wide_t = eng.lookup(params, ids, train=True)
    emb_i, wide_i = eng.lookup(params, ids, train=False)
    np.testing.assert_allclose(np.asarray(emb_t), np.asarray(emb_i),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(wide_t), np.asarray(wide_i),
                               rtol=1e-6, atol=1e-6)
