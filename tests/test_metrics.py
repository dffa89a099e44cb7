"""Metric parity: streaming AUC vs sklearn, ranking metrics vs numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from sklearn.metrics import roc_auc_score

from recsys.train import metrics as M


def _stream_auc(logits, labels, num_bins, chunks=4):
    state = M.init_binary_metrics(num_bins)
    for lo in range(0, len(logits), len(logits) // chunks):
        hi = lo + len(logits) // chunks
        state = M.update_binary_metrics(
            state, jnp.asarray(logits[lo:hi]), jnp.asarray(labels[lo:hi])
        )
    return M.finalize_binary_metrics(state)


def test_streaming_auc_close_to_sklearn(rng):
    n = 4000
    logits = rng.normal(size=n).astype(np.float32)
    # labels correlated with logits → AUC ≈ 0.76
    labels = (rng.normal(size=n) + logits > 0).astype(np.float32)
    exact = roc_auc_score(labels, 1 / (1 + np.exp(-logits)))
    out200 = _stream_auc(logits, labels, 200)
    out4k = _stream_auc(logits, labels, 4096)
    assert abs(out200["auc"] - exact) < 5e-3   # tf-style 200-bucket error
    assert abs(out4k["auc"] - exact) < 5e-4
    # streaming over chunks == one shot
    one = _stream_auc(logits, labels, 200, chunks=1)
    assert abs(one["auc"] - out200["auc"]) < 1e-9


def test_logloss_and_accuracy(rng):
    n = 1000
    logits = rng.normal(size=n).astype(np.float32)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    out = _stream_auc(logits, labels, 200)
    p = 1 / (1 + np.exp(-logits))
    ll = -np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p))
    acc = np.mean(np.round(p) == labels)
    assert abs(out["logloss"] - ll) < 1e-4
    assert abs(out["accuracy"] - acc) < 1e-6
    assert out["count"] == n


def _ndcg_oracle(scores, heldout, k):
    n_users = scores.shape[0]
    out = np.zeros(n_users)
    for u in range(n_users):
        order = np.argsort(-scores[u])[:k]
        gains = heldout[u, order]
        dcg = np.sum(gains / np.log2(np.arange(2, k + 2)))
        n_rel = int(min(heldout[u].sum(), k))
        idcg = np.sum(1.0 / np.log2(np.arange(2, n_rel + 2)))
        out[u] = dcg / max(idcg, 1e-10)
    return out


def test_ndcg_recall_vs_oracle(rng):
    u, i, k = 8, 50, 10
    scores = rng.normal(size=(u, i)).astype(np.float32)
    heldout = (rng.random((u, i)) < 0.1).astype(np.float32)
    heldout[0] = 0
    heldout[0, 3] = 1  # user with single heldout item
    got = np.asarray(M.ndcg_at_k(jnp.asarray(scores), jnp.asarray(heldout), k))
    np.testing.assert_allclose(got, _ndcg_oracle(scores, heldout, k),
                               rtol=1e-4, atol=1e-5)

    got_r = np.asarray(
        M.recall_at_k(jnp.asarray(scores), jnp.asarray(heldout), k)
    )
    for uu in range(u):
        order = np.argsort(-scores[uu])[:k]
        hits = heldout[uu, order].sum()
        denom = max(min(heldout[uu].sum(), k), 1e-10)
        assert abs(got_r[uu] - hits / denom) < 1e-5


def test_success_rate():
    pred = np.array([[1, 2], [3, 4], [5, 6]])
    true = np.zeros((3, 10))
    true[0, 2] = 1   # hit
    true[1, 9] = 1   # miss
    true[2, 5] = 1   # hit
    assert abs(M.success_rate_at_n(pred, true) - 200.0 / 3.0) < 1e-9


def test_nce(rng):
    y = (rng.random(500) < 0.3).astype(np.float64)
    p = np.full(500, y.mean())
    # predicting the base rate ⇒ NCE == 1
    assert abs(M.normalized_cross_entropy(y, p) - 1.0) < 1e-9


@pytest.mark.parametrize("case", ["continuous", "tied", "imbalanced"])
def test_roc_auc_matches_sklearn(case, rng):
    n = 5000
    score = rng.normal(size=n)
    if case == "tied":
        score = np.round(score, 1)          # many tied scores
    y = (rng.normal(size=n) + score > (1.5 if case == "imbalanced" else 0))
    assert abs(M.roc_auc(y, score) - roc_auc_score(y, score)) < 1e-12


def test_roc_auc_needs_both_classes():
    with pytest.raises(ValueError):
        M.roc_auc(np.ones(8), np.arange(8.0))
