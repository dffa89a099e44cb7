"""CDAE — Collaborative Denoising Auto-Encoder (cade/CDAE.py:5-48).

JAX re-design of the reference Keras model:
- item-vector input [B, I], dropout-corrupted at rate q (CDAE.py:26);
- hidden dense K with L2 reg + per-user embedding [U, K] added at the
  hidden layer (CDAE.py:27-35), activation on the sum;
- sigmoid output dense back to I items (CDAE.py:38);
- MSE reconstruction loss + Adam (cade/train.py:20-27);
- top-N prediction masks already-watched items (train.py:30-33) and is
  scored with SuccessRate@N (cade/metrics.py via
  `recsys.train.metrics.success_rate_at_n`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from recsys.ops import nn
from recsys.train import optim


def make_cdae(n_items: int, n_users: int, hidden: int = 50,
              drop_rate: float = 0.5, l2: float = 0.01):
    def init(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return {
            "enc": nn.dense_init(k1, n_items, hidden),
            "user_emb": nn.glorot_uniform(k2, (n_users, hidden)),
            "dec": nn.dense_init(k3, hidden, n_items),
        }

    def apply(params, x_items, user_ids, *, train=False, rng=None):
        h = x_items
        if train and rng is not None:
            h = nn.dropout(rng, h, drop_rate, True)
        h = nn.dense(params["enc"], h)
        h = h + jnp.take(params["user_emb"], user_ids, axis=0)
        h = jax.nn.relu(h)
        return jax.nn.sigmoid(nn.dense(params["dec"], h))

    def loss_fn(params, x_items, user_ids, *, rng=None, train=True):
        y = apply(params, x_items, user_ids, train=train, rng=rng)
        mse = jnp.mean((y - x_items) ** 2)
        reg = l2 * (
            jnp.sum(params["enc"]["w"] ** 2) + jnp.sum(params["enc"]["b"] ** 2)
            + jnp.sum(params["user_emb"] ** 2)
        )
        return mse + reg

    return init, apply, loss_fn


def train_cdae(
    train_x: np.ndarray, train_users: np.ndarray,
    *, hidden: int = 50, epochs: int = 100, batch_size: int = 128,
    lr: float = 1e-3, seed: int = 0, drop_rate: float = 0.5, l2: float = 0.01,
):
    """Fit loop (cade/train.py:24-27 semantics, bounded epochs)."""
    n_users, n_items = train_x.shape
    init, apply, loss_fn = make_cdae(n_items, n_users + 1, hidden,
                                     drop_rate, l2)
    params = init(jax.random.key(seed))
    opt = optim.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, xb, ub, rng):
        loss, grads = jax.value_and_grad(loss_fn)(params, xb, ub, rng=rng)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    key = jax.random.key(seed + 1)
    x = jnp.asarray(train_x)
    u = jnp.asarray(train_users.astype(np.int32))
    n = n_users
    losses = []
    for epoch in range(epochs):
        key, perm_key = jax.random.split(key)
        perm = jax.random.permutation(perm_key, n)
        for lo in range(0, n - batch_size + 1, batch_size):
            idx = perm[lo:lo + batch_size]
            key, sub = jax.random.split(key)
            params, opt_state, loss = step(params, opt_state, x[idx], u[idx],
                                           sub)
        losses.append(float(loss))
    return params, apply, losses


def predict_topn(apply, params, train_x: np.ndarray, users: np.ndarray,
                 n: int) -> np.ndarray:
    """Scores → mask watched → top-N item indices (train.py:30-33)."""
    pred = np.asarray(apply(params, jnp.asarray(train_x),
                            jnp.asarray(users.astype(np.int32))))
    pred = pred * (train_x == 0)
    return np.argsort(pred, axis=1)[:, -n:]
