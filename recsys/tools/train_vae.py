"""VAE-CF training CLI — parity with running vae-cf/vae_cf_train_val.py
(the reference trains on module import; here it is an explicit entry point).

Usage:
    python -m recsys.tools.train_vae \
        [--ratings_csv=/path/to/ml-20m/ratings.csv] \
        [--model=multi_vae|multi_dae|logistic_vae] \
        [--epochs=200] [--batch_size=500] [--anneal_cap=0.2] \
        [--total_anneal_steps=200000] [--model_dir=./vae_model] \
        [--n_heldout_users=10000]

Without --ratings_csv it runs on synthetic planted-low-rank interactions
(small, for smoke runs). Prints one JSON line with the best validation
NDCG@100 and the restored-best test metrics (NDCG@100 / Recall@20 /
Recall@50 — vae_cf_train_val.py:232-272).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys

from recsys.data import movielens as ML
from recsys.train.vae_loop import VaeTrainConfig, train_vae_cf


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)

    cfg = VaeTrainConfig()
    fields = {f.name: type(getattr(cfg, f.name))
              for f in dataclasses.fields(cfg)}
    updates = {}
    for k, v in kv.items():
        if k in fields:
            updates[k] = fields[k](v)
    cfg = dataclasses.replace(cfg, **updates)

    if "ratings_csv" in kv:
        data = ML.load_ml20m(
            kv["ratings_csv"],
            n_heldout_users=int(kv.get("n_heldout_users", 10000)),
        )
    else:
        u, i, r = ML.synthetic_interactions(
            n_users=int(kv.get("synthetic_users", 600)),
            n_items=int(kv.get("synthetic_items", 300)),
            seed=cfg.seed,
        )
        data = ML.preprocess_vae_cf(
            u, i, r, n_heldout_users=int(kv.get("n_heldout_users", 80)),
            rating_threshold=float(kv.get("rating_threshold", 3.5)),
        )

    result = train_vae_cf(data, cfg)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    from recsys.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
