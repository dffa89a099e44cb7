"""Model zoo: init/apply shapes, jit-compile, gradient flow for every model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys.core.config import CriteoConfig, ModelConfig
from recsys.models.api import make_model

# small vocab config for fast tests
SMALL = CriteoConfig(
    cont_boundaries=CriteoConfig().cont_boundaries,
    cat_vocabs=tuple([50] * 26),
)

CTR_MODELS = ["fm", "deepfm", "dcn", "xdeepfm", "dnn", "wide"]


def criteo_batch(rng, b=8):
    vocabs = SMALL.field_vocab_sizes
    ids = np.stack(
        [rng.integers(0, v, b) for v in vocabs], axis=1
    ).astype(np.int32)
    return {
        "ids": jnp.asarray(ids),
        "dense": jnp.asarray(rng.normal(size=(b, 13)).astype(np.float32)),
        "label": jnp.asarray((rng.random(b) < 0.3).astype(np.float32)),
    }


@pytest.mark.parametrize("name", CTR_MODELS)
def test_ctr_model_forward_and_grad(name, rng):
    cfg = ModelConfig(name=name, embedding_dim=8, deep_layers=(16, 8),
                      cross_layers=2, cin_layers=(6, 4))
    model = make_model(name, SMALL, cfg)
    params, state = model.init(jax.random.key(0))
    batch = criteo_batch(rng)

    logits, new_state = model.apply(params, state, batch, train=False)
    assert logits.shape == (8,)
    assert np.all(np.isfinite(np.asarray(logits)))

    # train mode under jit with grads
    def loss_fn(p):
        lg, ns = model.apply(p, state, batch, train=True,
                             rng=jax.random.key(1))
        lbl = batch["label"]
        return jnp.mean(
            jnp.maximum(lg, 0) - lg * lbl + jnp.log1p(jnp.exp(-jnp.abs(lg)))
        )

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert np.isfinite(float(loss))
    flat = jax.tree_util.tree_leaves(grads)
    assert any(float(jnp.abs(g).sum()) > 0 for g in flat)


def test_deterministic_eval(rng):
    model = make_model("deepfm", SMALL,
                       ModelConfig(embedding_dim=8, deep_layers=(16,)))
    params, state = model.init(jax.random.key(0))
    batch = criteo_batch(rng)
    l1, _ = model.apply(params, state, batch, train=False)
    l2, _ = model.apply(params, state, batch, train=False)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_din_forward_and_grad(rng):
    from recsys.core.config import ModelConfig
    model = make_model("din", 100, 20,
                       ModelConfig(name="din", embedding_dim=8,
                                   attention_layers=(8, 4),
                                   mlp_layers=(16, 8), use_bn=False))
    b, p = 6, 10
    batch = {
        "i_id": jnp.asarray(rng.integers(1, 100, b), jnp.int32),
        "i_cate": jnp.asarray(rng.integers(1, 20, b), jnp.int32),
        "hist_iid": jnp.asarray(rng.integers(0, 100, (b, p)), jnp.int32),
        "hist_cate": jnp.asarray(rng.integers(0, 20, (b, p)), jnp.int32),
        "label": jnp.asarray((rng.random(b) < 0.5).astype(np.float32)),
    }
    params, state = model.init(jax.random.key(0))
    logits, _ = model.apply(params, state, batch, train=False)
    assert logits.shape == (b,)

    def loss_fn(p):
        lg, _ = model.apply(p, state, batch, train=True, rng=jax.random.key(1))
        return jnp.mean(lg ** 2)

    grads = jax.jit(jax.grad(loss_fn))(params)
    assert np.isfinite(float(jnp.abs(grads["item_emb"]).sum()))
