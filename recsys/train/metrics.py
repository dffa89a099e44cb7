"""Metrics: streaming AUC/accuracy/logloss + ranking metrics.

Replacement for the reference's metric stack:

- ``tf.metrics.auc`` / ``tf.metrics.accuracy`` (deepfm/deepfm.py:130-133 and
  clones) → a jittable histogram-based streaming accumulator. The state is a
  small pytree that lives on device; updates run inside the jitted eval step,
  and under `jit` over a sharded batch XLA inserts the cross-chip reduction
  (the psum the SURVEY §2.2 row calls for) automatically.
- NDCG@k / Recall@k (vae-cf/vae_cf_train_val.py:84-118) → top_k-based jax
  functions.
- SuccessRate@N (cade/metrics.py:3-10) and Normalized Cross-Entropy
  (gbdt_feature_engineering/gbdt_lr.py:124-127) → numpy helpers.
- exact ROC-AUC over host arrays (`roc_auc`) → a numpy rank statistic.

AUC fidelity: tf.metrics.auc uses 200 linear thresholds with trapezoidal
integration; a 200-bin prediction histogram yields the same Riemann/trapezoid
approximation to within bin resolution. We default to 200 bins for parity
semantics and allow more bins for tighter estimates.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_NUM_BINS = 200


class BinaryMetricState(NamedTuple):
    """Streaming state for AUC + accuracy + logloss over a binary task."""

    pos_hist: jax.Array   # [num_bins] count of positive-label preds per bin
    neg_hist: jax.Array   # [num_bins]
    count: jax.Array      # scalar, examples seen
    loss_sum: jax.Array   # scalar, Σ per-example sigmoid CE
    correct: jax.Array    # scalar, Σ (round(p) == y)


def init_binary_metrics(num_bins: int = DEFAULT_NUM_BINS) -> BinaryMetricState:
    z = jnp.zeros((num_bins,), jnp.float32)
    s = jnp.zeros((), jnp.float32)
    return BinaryMetricState(z, z, s, s, s)


def update_binary_metrics(
    state: BinaryMetricState,
    logits: jax.Array,   # [B] raw logits
    labels: jax.Array,   # [B] {0,1}
    weights: jax.Array | None = None,  # [B] optional mask (e.g. padding)
) -> BinaryMetricState:
    """Jittable streaming update (sigmoid + scatter-add over the tiny bin
    axis)."""
    num_bins = state.pos_hist.shape[0]
    probs = jax.nn.sigmoid(logits)
    labels = labels.astype(jnp.float32)
    w = jnp.ones_like(probs) if weights is None else weights.astype(jnp.float32)

    bins = jnp.clip((probs * num_bins).astype(jnp.int32), 0, num_bins - 1)
    pos_w = labels * w
    neg_w = (1.0 - labels) * w
    pos_hist = state.pos_hist + jnp.zeros_like(state.pos_hist).at[bins].add(pos_w)
    neg_hist = state.neg_hist + jnp.zeros_like(state.neg_hist).at[bins].add(neg_w)

    # numerically-stable sigmoid CE: max(x,0) - x*y + log1p(exp(-|x|))
    ce = jnp.maximum(logits, 0.0) - logits * labels + jnp.log1p(
        jnp.exp(-jnp.abs(logits))
    )
    loss_sum = state.loss_sum + jnp.sum(ce * w)
    correct = state.correct + jnp.sum((jnp.round(probs) == labels) * w)
    count = state.count + jnp.sum(w)
    return BinaryMetricState(pos_hist, neg_hist, count, loss_sum, correct)


def finalize_binary_metrics(state: BinaryMetricState) -> dict[str, float]:
    """Trapezoidal ROC-AUC from the histograms + running means."""
    pos = np.asarray(state.pos_hist, np.float64)
    neg = np.asarray(state.neg_hist, np.float64)
    total_pos = pos.sum()
    total_neg = neg.sum()
    # Sweep threshold from high to low: cumulative sums from the top bin.
    tp = np.concatenate([[0.0], np.cumsum(pos[::-1])])
    fp = np.concatenate([[0.0], np.cumsum(neg[::-1])])
    tpr = tp / max(total_pos, 1.0)
    fpr = fp / max(total_neg, 1.0)
    auc = float(np.trapezoid(tpr, fpr))
    count = float(state.count)
    return {
        "auc": auc,
        "accuracy": float(state.correct) / max(count, 1.0),
        "logloss": float(state.loss_sum) / max(count, 1.0),
        "count": count,
    }


def roc_auc(y_true, y_score) -> float:
    """Exact ROC-AUC of host arrays: the Mann-Whitney U statistic with tied
    scores sharing their mean rank (the value sklearn's roc_auc_score
    gives). Raises if only one class is present."""
    y = np.asarray(y_true).ravel().astype(bool)
    score = np.asarray(y_score, np.float64).ravel()
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes present")
    order = np.argsort(score, kind="mergesort")
    sorted_score = score[order]
    # 1-based mean rank of each run of tied scores
    starts = np.flatnonzero(np.r_[True, sorted_score[1:] != sorted_score[:-1]])
    ends = np.r_[starts[1:], score.size]
    ranks = np.empty(score.size, np.float64)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    u = ranks[y].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


# ---------------------------------------------------------------------------
# Ranking metrics (VAE-CF protocol — vae_cf_train_val.py:84-118)
# ---------------------------------------------------------------------------

def ndcg_at_k(scores: jax.Array, heldout: jax.Array, k: int = 100) -> jax.Array:
    """NDCG@k per user, binary relevance.

    ``scores``: [U, I] predicted scores with train items already masked to
    -inf by the caller (vae_cf_train_val.py:208-210); ``heldout``: [U, I]
    binary heldout matrix. Matches the reference's bottleneck-based
    implementation (vae_cf_train_val.py:84-104): DCG over the top-k ranked
    items with 1/log2(rank+2) gains, IDCG over min(k, #heldout).
    """
    _, top_idx = jax.lax.top_k(scores, k)                    # [U, k]
    gains = jnp.take_along_axis(heldout, top_idx, axis=1)    # [U, k]
    discounts = 1.0 / jnp.log2(jnp.arange(2, k + 2, dtype=jnp.float32))
    dcg = jnp.sum(gains * discounts, axis=1)
    n_heldout = jnp.sum(heldout, axis=1).astype(jnp.int32)
    n_capped = jnp.minimum(n_heldout, k)
    ideal_cum = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(discounts)])
    idcg = ideal_cum[n_capped]
    return dcg / jnp.maximum(idcg, 1e-10)


def recall_at_k(scores: jax.Array, heldout: jax.Array, k: int = 20) -> jax.Array:
    """Recall@k per user: |top-k ∩ heldout| / min(k, |heldout|)
    (vae_cf_train_val.py:107-118)."""
    _, top_idx = jax.lax.top_k(scores, k)
    hits = jnp.sum(jnp.take_along_axis(heldout, top_idx, axis=1), axis=1)
    n_heldout = jnp.sum(heldout, axis=1)
    return hits / jnp.maximum(jnp.minimum(n_heldout, float(k)), 1e-10)


def success_rate_at_n(pred_topn: np.ndarray, true_mat: np.ndarray) -> float:
    """CDAE SuccessRate@N (cade/metrics.py:3-10): % of users whose top-N
    predictions intersect the true heldout set."""
    cnt = 0
    for i in range(pred_topn.shape[0]):
        true_items = np.where(true_mat[i] == 1)[0]
        if np.intersect1d(pred_topn[i], true_items).size > 0:
            cnt += 1
    return cnt * 100.0 / pred_topn.shape[0]


def normalized_cross_entropy(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """NCE (gbdt_lr.py:124-127): logloss normalized by the entropy of the
    base rate."""
    y_true = np.asarray(y_true, np.float64)
    y_prob = np.clip(np.asarray(y_prob, np.float64), 1e-15, 1 - 1e-15)
    ll = -np.mean(y_true * np.log(y_prob) + (1 - y_true) * np.log(1 - y_prob))
    p = float(np.clip(y_true.mean(), 1e-15, 1 - 1e-15))  # degenerate base rate
    base = -(p * np.log(p) + (1 - p) * np.log(1 - p))
    return float(ll / base)
