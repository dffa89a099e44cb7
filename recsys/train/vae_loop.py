"""VAE-CF training driver — the product implementation of the reference's
hand-rolled session loop (vae-cf/vae_cf_train_val.py:161-272):

- epoch loop over shuffled training users, per-step KL anneal
  β = min(cap, step/total_anneal_steps) (vae_cf_train_val.py:79-81,184-193),
- per-epoch validation: score fold-in rows, mask seen items to -inf,
  NDCG@100 over heldout (vae_cf_train_val.py:202-221),
- best-NDCG checkpoint retention (vae_cf_train_val.py:224-226),
- restore-best-and-test protocol reporting NDCG@100 / Recall@20 / Recall@50
  (vae_cf_train_val.py:232-272),
- JSONL scalar stream standing in for the reference's TensorBoard summaries
  (vae_cf_train_val.py:129-144).

Shape notes: training batches are dense [B, I] float32 staged from the
host csr matrix (the reference does the same densification per batch,
vae_cf_train_val.py:173-181); the whole step is a handful of matmuls.
Eval batches are padded to a fixed size so one jitted scorer serves every
batch (static shapes — no per-tail recompile).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from recsys.core.checkpoint import CheckpointManager
from recsys.data.movielens import VaeCfData
from recsys.models import vae_cf as V
from recsys.train import metrics as M
from recsys.train import optim
from recsys.train.summaries import ScalarWriter

log = logging.getLogger("recsys.vae")


@dataclass(frozen=True)
class VaeTrainConfig:
    """VAE-CF run config (constants block, vae_cf_train_val.py:64-82)."""

    model: str = "multi_vae"        # multi_vae | multi_dae | logistic_vae
    latent_dim: int = 200           # p_dims=[200, 600, n_items]
    hidden_dim: int = 600
    batch_size: int = 500           # vae_cf_train_val.py:170-181
    epochs: int = 200
    learning_rate: float = 1e-3
    keep_prob: float = 0.5
    anneal_cap: float = 0.2         # vae_cf_train_val.py:79-81
    total_anneal_steps: int = 200_000
    lam: float = 0.0                # best MultiVAE^PR run used no weight decay
    seed: int = 98765
    model_dir: str = "./vae_model"
    eval_batch_size: int = 500


def _make_model(cfg: VaeTrainConfig, n_items: int):
    p_dims = (cfg.latent_dim, cfg.hidden_dim, n_items)
    if cfg.model == "multi_dae":
        return V.make_multi_dae(p_dims, lam=cfg.lam), False
    if cfg.model == "multi_vae":
        return V.make_multi_vae(p_dims, lam=cfg.lam), True
    if cfg.model == "logistic_vae":
        return V.make_multi_vae(p_dims, lam=cfg.lam,
                                likelihood="logistic"), True
    raise ValueError(f"unknown VAE-CF model {cfg.model!r}")


def _dense_rows(mat, idx: np.ndarray) -> np.ndarray:
    return np.asarray(mat[idx].todense(), np.float32)


def make_eval_fn(apply, vae: bool, batch: int):
    """Jitted fixed-shape scorer: fold-in rows → (ndcg@100, r@20, r@50) sums.

    Scores the fold-in batch, masks already-seen items to -inf
    (vae_cf_train_val.py:208-210), and reduces each metric over the valid
    rows so padded tail rows contribute nothing.
    """

    @jax.jit
    def score(params, x_tr, x_te, valid):
        out = apply(params, x_tr, train=False)
        logits = out[0] if vae else out
        logits = jnp.where(x_tr > 0, -jnp.inf, logits)
        has_heldout = (jnp.sum(x_te, axis=1) > 0) & valid
        w = has_heldout.astype(jnp.float32)
        n = jnp.sum(w)
        ndcg = jnp.sum(M.ndcg_at_k(logits, x_te, k=100) * w)
        r20 = jnp.sum(M.recall_at_k(logits, x_te, k=20) * w)
        r50 = jnp.sum(M.recall_at_k(logits, x_te, k=50) * w)
        return ndcg, r20, r50, n

    def evaluate(params, tr_mat, te_mat) -> dict[str, float]:
        n_users = tr_mat.shape[0]
        sums = np.zeros(4)
        for lo in range(0, n_users, batch):
            idx = np.arange(lo, min(lo + batch, n_users))
            x_tr = _dense_rows(tr_mat, idx)
            x_te = _dense_rows(te_mat, idx)
            valid = np.ones(len(idx), bool)
            if len(idx) < batch:                      # pad to static shape
                pad = batch - len(idx)
                x_tr = np.pad(x_tr, ((0, pad), (0, 0)))
                x_te = np.pad(x_te, ((0, pad), (0, 0)))
                valid = np.pad(valid, (0, pad))
            out = score(params, jnp.asarray(x_tr), jnp.asarray(x_te),
                        jnp.asarray(valid))
            sums += np.asarray([float(v) for v in out])
        n = max(sums[3], 1.0)
        return {"ndcg@100": sums[0] / n, "recall@20": sums[1] / n,
                "recall@50": sums[2] / n, "eval_users": int(sums[3])}

    return evaluate


def train_vae_cf(data: VaeCfData, cfg: VaeTrainConfig) -> dict:
    """Full train / validate / test protocol. Returns
    {"best_ndcg": ..., "best_epoch": ..., "test": {...}}."""
    (init, apply, loss_fn), vae = _make_model(cfg, data.n_items)
    params = init(jax.random.key(cfg.seed))
    opt = optim.adam(cfg.learning_rate)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, x, rng, anneal):
        def lf(p):
            if vae:
                return loss_fn(p, x, anneal, rng=rng, train=True,
                               keep_prob=cfg.keep_prob)
            return loss_fn(p, x, rng=rng, train=True,
                           keep_prob=cfg.keep_prob)

        (loss, aux), grads = jax.value_and_grad(lf, has_aux=True)(params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss, aux

    evaluate = make_eval_fn(apply, vae, cfg.eval_batch_size)
    mgr = CheckpointManager(cfg.model_dir, keep_max=3)
    rng_np = np.random.default_rng(cfg.seed)
    key = jax.random.key(cfg.seed + 1)
    n_train = data.train.shape[0]
    bs = min(cfg.batch_size, n_train)
    step = 0
    best = {"ndcg": -1.0, "epoch": -1}

    with ScalarWriter(cfg.model_dir) as writer:
        for epoch in range(cfg.epochs):
            order = rng_np.permutation(n_train)
            losses = []
            # full-epoch coverage incl. the final partial batch
            # (vae_cf_train_val.py:172 end_idx=min(st+bs, N)); the tail size
            # n_train % bs is constant across epochs → exactly one extra
            # compiled shape, no per-epoch recompiles
            for lo in range(0, n_train, bs):
                x = jnp.asarray(_dense_rows(data.train, order[lo:lo + bs]))
                key, sub = jax.random.split(key)
                anneal = V.anneal_schedule(
                    step, cap=cfg.anneal_cap,
                    total_anneal_steps=cfg.total_anneal_steps)
                params, opt_state, loss, _ = train_step(
                    params, opt_state, x, sub, jnp.float32(anneal))
                losses.append(float(loss))
                step += 1

            val = evaluate(params, data.vad_tr, data.vad_te)
            writer.write(step, epoch=epoch, loss=float(np.mean(losses)),
                         anneal=anneal, **{k: v for k, v in val.items()})
            log.info("epoch %d step %d loss %.4f val ndcg@100 %.4f",
                     epoch, step, float(np.mean(losses)), val["ndcg@100"])
            # best-NDCG retention (vae_cf_train_val.py:224-226)
            mgr.save(step, params, metric=val["ndcg@100"],
                     extra={"epoch": epoch})
            if val["ndcg@100"] > best["ndcg"]:
                best = {"ndcg": val["ndcg@100"], "epoch": epoch}

    # restore-best-and-test (vae_cf_train_val.py:232-272)
    restored = mgr.restore(params, best=True)
    assert restored is not None
    best_params, best_step, extra = restored
    test = evaluate(best_params, data.test_tr, data.test_te)
    log.info("test (best epoch %s): %s", extra.get("epoch"), test)
    return {
        "best_ndcg": best["ndcg"],
        "best_epoch": best["epoch"],
        "best_step": best_step,
        "test": test,
    }
