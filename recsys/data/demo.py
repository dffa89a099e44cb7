"""The DeepFM demo schema: two hashed-int id features (u_id, i_id).

Parity with deepfm/deepfm.py:37-51 (build_model_columns): the reference's
DeepFM README experiments run on a two-column demo dataset —
``categorical_column_with_hash_bucket('u_id', 500000, tf.int64)`` and
``('i_id', 100000)`` — not on Criteo. Here that schema is a CriteoConfig
with no continuous fields and two hashed categorical vocabs; the whole CTR
zoo (which is generic over ``field_vocab_sizes``) runs on it unchanged.

The raw int64 ids are hashed host-side with the same splitmix64 bucket hash
the native loader uses (recsys.data.hashing.hash_int_bucket).
"""

from __future__ import annotations

import numpy as np

from recsys.core.config import CriteoConfig
from recsys.data import hashing


def demo_schema(u_buckets: int = 500_000,
                i_buckets: int = 100_000) -> CriteoConfig:
    """Feature statics for the u_id/i_id demo dataset
    (deepfm/deepfm.py:41-49)."""
    return CriteoConfig(cont_boundaries=(), cat_vocabs=(u_buckets, i_buckets))


def hash_demo_batch(u_ids: np.ndarray, i_ids: np.ndarray,
                    labels: np.ndarray | None,
                    schema: CriteoConfig) -> dict:
    """Raw int64 (u_id, i_id) → model batch {'ids' [B,2], 'dense' [B,0],
    'label'}."""
    u_b, i_b = schema.cat_vocabs
    ids = np.stack([
        hashing.hash_int_bucket(np.asarray(u_ids), u_b),
        hashing.hash_int_bucket(np.asarray(i_ids), i_b),
    ], axis=1)
    batch = {
        "ids": ids.astype(np.int32),
        "dense": np.zeros((len(ids), 0), np.float32),
    }
    if labels is not None:
        batch["label"] = np.asarray(labels, np.float32)
    return batch


def synthetic_demo(n_rows: int, *, n_users: int = 5000, n_items: int = 1000,
                   rank: int = 8, seed: int = 0,
                   schema: CriteoConfig | None = None) -> dict:
    """Planted low-rank user×item CTR: raw ids + labels → hashed batch.

    Stands in for the Hive-table dump the reference trains on
    (deepfm/gen_tfrecords.py:6-11) so the demo pipeline is testable without
    the private dataset.
    """
    rng = np.random.default_rng(seed)
    u_f = rng.normal(size=(n_users, rank))
    i_f = rng.normal(size=(n_items, rank))
    u = rng.integers(0, n_users, n_rows)
    i = rng.integers(0, n_items, n_rows)
    logit = (u_f[u] * i_f[i]).sum(axis=1) / np.sqrt(rank) - 0.5
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    # raw ids offset into a sparse int64 key space like real uids
    return hash_demo_batch(u * 7919 + 13, i * 104729 + 7, y,
                           schema or demo_schema())
