"""DIN training CLI — task_type={train,eval,predict,export,serve} for the
Deep Interest Network (reference: din/din.py:204-248, the same estimator
task_type switch every CTR script carries).

Usage:
    python -m recsys.tools.train_din train \
        --model.embedding_dim=32 --train.batch_size=1024 \
        --train.num_steps=2000 [--data=examples.npz]
    python -m recsys.tools.train_din export --export_dir=./export_din
    python -m recsys.tools.train_din serve --export_dir=./export_din \
        --port=8500 [--device=cpu]

Data: ``--data=<path.npz>`` loads a `data.amazon.DinDataset` persisted with
`amazon.save_din_npz` (the offline artifact replacing the reference's
pre-built ``train2``/``valid2`` TFRecords, din/din.py:197-198); without it
the hardened planted task (`amazon.synthetic_din_hard`) is generated —
target band AUC ≈ 0.82–0.88.
"""

from __future__ import annotations

import logging
import sys

import numpy as np

from recsys.core.config import RunConfig, apply_overrides, to_json
from recsys.data import amazon
from recsys.models.api import make_model
from recsys.train import loop

log = logging.getLogger("recsys")


def _load_dataset(kv: dict) -> amazon.DinDataset:
    if "data" in kv:
        return amazon.load_din_npz(kv["data"])
    n_users = int(kv.get("synthetic_users", 40_000))
    return amazon.synthetic_din_hard(
        n_users=n_users, item_vocab=int(kv.get("item_vocab", 2000)),
        cate_vocab=int(kv.get("cate_vocab", 40)))


def _split(ds: amazon.DinDataset, holdout_frac: float = 0.1):
    """Deterministic example-level split (pos/neg pairs stay adjacent, so
    split on even boundaries to keep both halves label-balanced)."""
    n = len(ds.label)
    hold = max(2, int(n * holdout_frac) // 2 * 2)
    data = {"i_id": ds.i_id, "i_cate": ds.i_cate, "hist_iid": ds.hist_iid,
            "hist_cate": ds.hist_cate, "label": ds.label}
    train = {k: v[:-hold] for k, v in data.items()}
    evald = {k: v[-hold:] for k, v in data.items()}
    return train, evald


def _batch_iter(data: dict, batch_size: int, seed: int, num_epochs: int = -1):
    n = len(data["label"])
    epoch = 0
    while num_epochs < 0 or epoch < num_epochs:
        rng = np.random.default_rng([seed, epoch])
        order = rng.permutation(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            idx = order[lo:lo + batch_size]
            yield {k: v[idx] for k, v in data.items()}
        epoch += 1


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    task = argv[0] if argv and not argv[0].startswith("--") else "train"
    _FLAT = ("--data", "--export_dir", "--port", "--device", "--buckets",
             "--synthetic_users", "--item_vocab", "--cate_vocab")
    overrides = [a for a in argv if a.startswith("--") and "=" in a
                 and not a.startswith(_FLAT)]
    kv = dict(
        a[2:].split("=", 1) for a in argv if a.startswith(_FLAT) and "=" in a
    )
    import dataclasses

    from recsys.core.config import ModelConfig
    base = dataclasses.replace(
        RunConfig(),
        model=ModelConfig(name="din", embedding_dim=32, use_bn=False,
                          dropout=0.1))
    cfg = apply_overrides(base, overrides)
    log.info("config: %s", to_json(cfg))

    if task == "serve":
        # identical serving stack to train_ctr (Servable reconstructs DIN
        # from factory_kwargs); delegate so the surfaces stay one codepath
        from recsys.tools import train_ctr
        return train_ctr.main(["serve"] + argv[1:])

    ds = _load_dataset(kv)
    model = make_model("din", ds.item_vocab, ds.cate_vocab, cfg.model)
    train_data, eval_data = _split(ds)
    bs = min(cfg.train.batch_size, len(eval_data["label"]))

    def eval_batches():
        return _batch_iter(eval_data, bs, seed=0, num_epochs=1)

    if task == "train":
        num_steps = cfg.train.num_steps
        if num_steps < 0:
            num_steps = (cfg.train.num_epochs * len(train_data["label"])
                         // cfg.train.batch_size)
        metrics = loop.train_and_evaluate(
            model, _batch_iter(train_data, cfg.train.batch_size,
                               cfg.train.seed),
            eval_batches, cfg.train, num_steps=num_steps)
        print(metrics)
        return metrics

    # eval / predict / export restore trained weights
    from recsys.core.checkpoint import CheckpointManager
    from recsys.train.train_state import create_train_state
    mgr = CheckpointManager(cfg.train.model_dir, cfg.train.keep_checkpoint_max)
    ts, _ = create_train_state(model, cfg.train.seed, cfg.train.learning_rate)
    restored = mgr.restore((ts.params, ts.model_state, ts.opt_state))
    if restored is not None:
        (params, model_state, _), step, _ = restored
        log.info("loaded checkpoint step %d", step)
    else:
        params, model_state = ts.params, ts.model_state
        log.warning("no checkpoint; fresh params")

    if task == "eval":
        metrics = loop.evaluate(model, params, model_state, eval_batches(),
                                max_steps=cfg.train.eval_steps * 10)
        print(metrics)
        return metrics
    if task == "predict":
        from recsys.train.train_state import make_predict_step
        predict = make_predict_step(model)
        probs = [np.asarray(predict(params, model_state, b))
                 for b in eval_batches()]
        out = np.concatenate(probs)
        print({"num_predictions": len(out), "mean_prob": float(out.mean())})
        return {"probs": out}
    if task == "export":
        from recsys.serve.export import export_servable
        d = export_servable(
            kv.get("export_dir", "./export_din"), "din",
            params, model_state, cfg.model, criteo_cfg=None,
            factory_kwargs={"item_vocab": ds.item_vocab,
                            "cate_vocab": ds.cate_vocab})
        print({"export_dir": d})
        return {"export_dir": d}
    raise SystemExit(f"unknown task {task}")


if __name__ == "__main__":
    from recsys.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
