"""CF family: Multi-DAE/Multi-VAE/Logistic-VAE + CDAE end-to-end on
synthetic MovieLens-like data (SURVEY §2.1 rows 11-12)."""

import jax
import jax.numpy as jnp
import numpy as np

from recsys.data import movielens as ML
from recsys.models import cdae as CDAE
from recsys.models import vae_cf as V
from recsys.train import metrics as M
from recsys.train import optim


def _vae_data():
    u, i, r = ML.synthetic_interactions(n_users=400, n_items=150, seed=3)
    return ML.preprocess_vae_cf(u, i, r, n_heldout_users=60,
                                rating_threshold=0.0)


def test_preprocess_protocol():
    data = _vae_data()
    assert data.train.shape[1] == data.n_items
    assert data.vad_tr.shape == data.vad_te.shape
    # fold-in and heldout are disjoint
    overlap = data.vad_tr.multiply(data.vad_te)
    assert overlap.nnz == 0
    # ~20% heldout
    frac = data.vad_te.nnz / max(data.vad_tr.nnz + data.vad_te.nnz, 1)
    assert 0.1 < frac < 0.35


def _train_vae(loss_fn, init, n_items, train_mat, steps=60, lr=1e-3,
               vae=True):
    params = init(jax.random.key(0))
    opt = optim.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, x, rng, anneal):
        if vae:
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, x, anneal, rng=rng)
        else:
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, x, rng=rng)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    dense = np.asarray(train_mat.todense(), np.float32)
    n = dense.shape[0]
    key = jax.random.key(1)
    losses = []
    bs = 100
    for s in range(steps):
        lo = (s * bs) % max(n - bs, 1)
        x = jnp.asarray(dense[lo:lo + bs])
        key, sub = jax.random.split(key)
        anneal = V.anneal_schedule(s, cap=0.2, total_anneal_steps=1000)
        params, opt_state, loss = step(params, opt_state, x, sub, anneal)
        losses.append(float(loss))
    return params, losses


def test_multi_dae_learns():
    data = _vae_data()
    init, apply, loss_fn = V.make_multi_dae((20, 60, data.n_items), lam=0.0)
    params, losses = _train_vae(loss_fn, init, data.n_items, data.train,
                                vae=False)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_multi_vae_learns_and_ranks():
    data = _vae_data()
    init, apply, loss_fn = V.make_multi_vae((20, 60, data.n_items))
    params, losses = _train_vae(loss_fn, init, data.n_items, data.train,
                                steps=120)
    assert np.mean(losses[-10:]) < np.mean(losses[:10])

    # rank heldout items for validation users: fold-in → scores, mask seen
    x = jnp.asarray(np.asarray(data.vad_tr.todense(), np.float32))
    logits, _ = apply(params, x, train=False)
    scores = np.array(logits)   # writable copy
    scores[np.asarray(data.vad_tr.todense()) > 0] = -np.inf
    ndcg = np.asarray(M.ndcg_at_k(
        jnp.asarray(scores),
        jnp.asarray(np.asarray(data.vad_te.todense(), np.float32)),
        k=20,
    ))
    users_with_heldout = np.asarray(data.vad_te.sum(axis=1)).ravel() > 0
    # planted low-rank structure ⇒ clearly better than random
    assert ndcg[users_with_heldout].mean() > 0.05


def test_logistic_vae_variant():
    data = _vae_data()
    init, apply, loss_fn = V.make_multi_vae((20, 60, data.n_items),
                                            likelihood="logistic")
    params, losses = _train_vae(loss_fn, init, data.n_items, data.train)
    assert np.isfinite(losses).all()


def test_cdae_end_to_end():
    users, train_x, _, test_x = ML.synthetic_ml100k(n_users=150, n_items=80,
                                                    seed=5)
    params, apply, losses = CDAE.train_cdae(
        train_x, users, hidden=16, epochs=15, batch_size=32)
    assert np.isfinite(losses).all()
    pred = CDAE.predict_topn(apply, params, train_x, users, n=10)
    assert pred.shape == (150, 10)
    sr = M.success_rate_at_n(pred, test_x)
    assert sr > 15.0  # planted structure ⇒ far above random (10/80 ≈ 12%)


def test_vae_cf_product_trainer(tmp_path):
    """train_vae_cf runs the full reference protocol: anneal, per-epoch
    NDCG@100 validation, best-NDCG ckpt, restore-and-test
    (vae_cf_train_val.py:161-272)."""
    from recsys.core.checkpoint import CheckpointManager
    from recsys.train.summaries import read_scalars
    from recsys.train.vae_loop import VaeTrainConfig, train_vae_cf

    data = _vae_data()
    cfg = VaeTrainConfig(
        latent_dim=16, hidden_dim=48, epochs=6, batch_size=100,
        total_anneal_steps=500, model_dir=str(tmp_path / "vae"),
        eval_batch_size=64,
    )
    result = train_vae_cf(data, cfg)
    # test metrics computed from the restored best checkpoint
    assert result["best_ndcg"] > 0.0
    assert 0 <= result["best_epoch"] < cfg.epochs
    assert result["test"]["eval_users"] > 0
    assert np.isfinite(result["test"]["ndcg@100"])

    # the best/ checkpoint is the max-NDCG epoch, not the last epoch
    mgr = CheckpointManager(cfg.model_dir)
    import json, os
    with open(os.path.join(cfg.model_dir, "best", "meta.json")) as f:
        meta = json.load(f)
    assert meta["metric"] == result["best_ndcg"]
    assert meta["extra"]["epoch"] == result["best_epoch"]

    # JSONL scalar stream has one validation record per epoch
    scalars = read_scalars(cfg.model_dir)
    assert len(scalars) == cfg.epochs
    assert all("ndcg@100" in s and "loss" in s for s in scalars)
    # anneal schedule actually annealed
    assert scalars[-1]["anneal"] > scalars[0]["anneal"]


def test_train_vae_cli(tmp_path):
    from recsys.tools.train_vae import main

    result = main([
        "--epochs=2", "--batch_size=100", "--latent_dim=12",
        "--hidden_dim=32", f"--model_dir={tmp_path}/cli_vae",
        "--synthetic_users=250", "--synthetic_items=120",
        "--n_heldout_users=40", "--total_anneal_steps=200",
        "--eval_batch_size=64",
    ])
    assert "test" in result and result["best_epoch"] >= 0
