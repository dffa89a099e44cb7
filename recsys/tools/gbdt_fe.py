"""GBDT feature-engineering CLI — runs both reference pipelines
(gbdt_feature_engineering/gbdt_lr.py and main.py) on a CSV or synthetic data.

Usage:
    python -m recsys.tools.gbdt_fe \
        [--csv=/path/to/train.csv --target=Cover_Type [--drop=Id]] \
        [--n_trees=100] [--num_leaves=63] \
        [--stage1_trees=10] [--stage2_trees=40]

Prints one JSON line with:
- "gbdt_lr": the leaf-one-hot → LogisticRegression-over-C-grid pipeline's
  best NCE and C (gbdt_lr.py:59-128),
- "comparison": the raw vs raw+leaf second-stage accuracy experiment
  (main.py:20-118).
"""

from __future__ import annotations

import json
import logging
import sys

import numpy as np

from recsys.models import gbdt_lr as G


def _synthetic_forest(n=2000, n_classes=4, seed=0):
    """Planted multi-class task standing in for the Forest-Cover train.csv."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    w = rng.normal(size=(12, n_classes))
    logits = x @ w + 0.5 * (x[:, :1] * x[:, 1:2]) @ rng.normal(
        size=(1, n_classes))
    y = np.argmax(logits + rng.gumbel(0, 0.5, logits.shape), axis=1)
    return x, y.astype(np.int64)


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a[2:].split("=", 1) for a in argv
              if a.startswith("--") and "=" in a)

    if "csv" in kv:
        import pandas as pd

        df = pd.read_csv(kv["csv"])
        for col in kv.get("drop", "Id").split(","):
            if col in df.columns:
                del df[col]
        target = kv.get("target", "Cover_Type")
        y = df[target].to_numpy()
        x = df.drop(target, axis=1).to_numpy(np.float32)
    else:
        x, y = _synthetic_forest(
            n=int(kv.get("synthetic_rows", 2000)),
            seed=int(kv.get("seed", 0)))

    # shuffle before the train/val split (main.py:23 data.sample) — the
    # documented Forest-Cover train.csv is grouped by Cover_Type, so an
    # unshuffled head slice can be single-class and the NCE degenerate
    rng = np.random.default_rng(int(kv.get("seed", 0)))
    order = rng.permutation(len(y))
    x, y = x[order], y[order]
    n_val = max(1, len(y) // 5)
    binary_y = (y == np.unique(y)[0]).astype(np.int64)  # LR stage is binary
    gbdt_lr = G.gbdt_lr_pipeline(
        x[n_val:], binary_y[n_val:], x[:n_val], binary_y[:n_val],
        n_trees=int(kv.get("n_trees", 100)),
        num_leaves=int(kv.get("num_leaves", 63)),
    )
    comparison = G.leaf_feature_comparison(
        x, y,
        stage1_trees=int(kv.get("stage1_trees", 10)),
        stage2_trees=int(kv.get("stage2_trees", 40)),
        num_leaves=int(kv.get("num_leaves", 63)),
        seed=int(kv.get("seed", 0)),
    )
    result = {
        "gbdt_lr": {"nce": gbdt_lr["nce"], "C": gbdt_lr["C"],
                    "leaf_width": gbdt_lr["leaf_width"]},
        "comparison": comparison,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
