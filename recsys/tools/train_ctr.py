"""CTR training CLI — the ``task_type={train,eval,predict,export,serve}``
entry point (replaces ``python <model>.py --task_type=...`` in every
reference script, fm/fm.py:211-224, deepfm/deepfm.py:197-234).

Usage:
    python -m recsys.tools.train_ctr train \
        --model.name=deepfm --train.batch_size=8192 --train.num_steps=2000 \
        [--data_dir=/path/to/npz/shards | synthetic by default]
    python -m recsys.tools.train_ctr export --export_dir=./export ...
    python -m recsys.tools.train_ctr serve --export_dir=./export --port=8500
"""

from __future__ import annotations

import glob
import logging
import os
import sys
import threading

if (len(sys.argv) > 1 and sys.argv[1] == "serve"):
    # latency serving: multithreaded BLAS parks sibling threads that then
    # fight other processes for host cores, stalling a small matmul for a
    # whole scheduler timeslice. The tiny CTR towers never need BLAS
    # threads; force single-thread BEFORE numpy loads OpenBLAS.
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
    os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np

from recsys.core.config import RunConfig, apply_overrides, to_json
from recsys.data import criteo, loader
from recsys.models.api import make_model
from recsys.train import loop


def _synthetic_shards(tmp_dir: str, rows: int, shards: int, cfg):
    import os
    if not os.path.exists(os.path.join(tmp_dir, "part-r-00000.npz")):
        criteo.write_synthetic_shards(tmp_dir, rows, shards, cfg)
    return sorted(glob.glob(f"{tmp_dir}/part-r-*.npz"))


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    task = argv[0] if argv and not argv[0].startswith("--") else "train"
    # flat (non-config-section) args, e.g. --data_dir=...; everything else
    # with a '=' is a --section.key=value RunConfig override
    _FLAT = ("--data_dir", "--export_dir", "--port", "--synthetic_rows",
             "--hbm_data_budget", "--device", "--buckets", "--engine")
    overrides = [a for a in argv if a.startswith("--") and "=" in a
                 and not a.startswith(_FLAT)]
    kv = dict(
        a[2:].split("=", 1) for a in argv if a.startswith(_FLAT) and "=" in a
    )

    cfg = apply_overrides(RunConfig(), overrides)
    logging.getLogger("recsys").info("config: %s", to_json(cfg))

    if task == "serve":
        # --device=cpu: serve on the host CPU, as the reference serves on
        # CPU TF-Serving (deepfm/readme.md:64-73); the default device
        # otherwise
        if kv.get("device") == "cpu":
            import jax
            jax.config.update("jax_platforms", "cpu")
        from recsys.serve.export import DEFAULT_BUCKETS, Servable
        from recsys.serve.server import start_servers

        buckets = (tuple(int(b) for b in kv["buckets"].split(","))
                   if "buckets" in kv else DEFAULT_BUCKETS)
        # --engine=numpy: straight-line NumPy/BLAS inference (the CPU
        # latency path, serve/numpy_engine.py) — no XLA per-op dispatch,
        # no bucket padding, instant warmup
        sv = Servable(kv["export_dir"], buckets=buckets,
                      engine=kv.get("engine", "jit"))
        sv.warmup()
        # after warmup the long-lived objects (tables, executables) are
        # final: collect once and freeze them out of future GC scans —
        # gen-2 collections over the big param arrays were multi-ms pauses
        # showing up as 40× p99/p50 tail blowups in the serving benchmarks
        import gc
        gc.collect()
        gc.freeze()
        endpoints, stop = start_servers(sv, int(kv.get("port", 8500)))
        logging.getLogger("recsys").info(
            "serving %s on %s", sv.model_name,
            " ".join(f"{k}:{v}" for k, v in endpoints.items()))
        try:
            threading.Event().wait()
        finally:
            stop()
        return {}

    model = make_model(cfg.model.name, cfg.criteo, cfg.model)

    data_dir = kv.get("data_dir")
    if data_dir:
        shard_paths = sorted(glob.glob(f"{data_dir}/part-r-*.npz"))
    else:
        rows = int(kv.get("synthetic_rows", 2_000_000))
        shard_paths = _synthetic_shards("./synthetic_criteo", rows, 20,
                                        cfg.criteo)
    n_eval = max(1, len(shard_paths) // 10)
    train_paths, eval_paths = shard_paths[:-n_eval], shard_paths[-n_eval:]

    def eval_batches():
        return loader.ShardSource(
            eval_paths, cfg.train.batch_size, shuffle=False, num_epochs=1)

    if task == "train":
        import os
        total_bytes = sum(os.path.getsize(p) for p in train_paths)
        # exact epoch size: read each shard's label length from the npz
        # header (cheap — no array data is loaded until indexed)
        rows_total = 0
        for p in train_paths:
            with np.load(p) as z:
                rows_total += z["label"].shape[0]
        num_steps = cfg.train.num_steps
        if num_steps < 0:
            num_steps = cfg.train.num_epochs * rows_total // cfg.train.batch_size

        def load_all(paths):
            parts = [dict(np.load(p)) for p in paths]
            return {
                k: np.concatenate([p[k] for p in parts])
                for k in parts[0]
            }

        import jax
        n_devices = len(jax.devices())
        mesh_devices = (cfg.mesh.data_axis if cfg.mesh.data_axis > 0
                        else n_devices // max(1, cfg.mesh.model_axis)
                        ) * max(1, cfg.mesh.model_axis)
        # Mesh path: more than one device in the mesh → streaming SPMD
        # driver (batch over 'data', tables over 'model'; ShardSource epochs
        # + device_prefetch — no whole-dataset host residency; the
        # reference's MirroredStrategy train_and_evaluate equivalent).
        if mesh_devices > 1:
            from recsys.train import spmd_loop
            src = loader.ShardSource(
                train_paths, cfg.train.batch_size, seed=cfg.train.seed,
                num_epochs=-1)
            metrics = spmd_loop.train_and_evaluate_spmd_stream(
                model, iter(src), eval_batches, cfg.train, cfg.mesh,
                num_steps=num_steps,
            )
            print(metrics)
            return metrics

        # Fast path: dataset fits in HBM → stage it on device and run
        # scan-fused steps (recsys.train.fast). Streaming path otherwise.
        hbm_budget = int(kv.get("hbm_data_budget", 4 << 30))
        if total_bytes < hbm_budget and "--streaming" not in argv:
            metrics = loop.train_and_evaluate_fast(
                model, load_all(train_paths), load_all(eval_paths),
                cfg.train, num_steps=num_steps,
            )
        else:
            src = loader.ShardSource(
                train_paths, cfg.train.batch_size, seed=cfg.train.seed,
                num_epochs=-1,
            )
            metrics = loop.train_and_evaluate(
                model, iter(src), eval_batches, cfg.train,
                num_steps=num_steps)
        print(metrics)
        return metrics

    # eval / predict / export need trained weights
    from recsys.core.checkpoint import CheckpointManager
    from recsys.train.train_state import create_train_state
    mgr = CheckpointManager(cfg.train.model_dir, cfg.train.keep_checkpoint_max)
    # checkpoints store (params, model_state, opt_state)
    ts, _ = create_train_state(model, cfg.train.seed, cfg.train.learning_rate)
    restored = mgr.restore((ts.params, ts.model_state, ts.opt_state))
    if restored is not None:
        (params, model_state, _), step, _ = restored
        logging.getLogger("recsys").info("loaded checkpoint step %d", step)
    else:
        params, model_state = ts.params, ts.model_state
        logging.getLogger("recsys").warning("no checkpoint; fresh params")

    if task == "eval":
        metrics = loop.evaluate(model, params, model_state, eval_batches(),
                                max_steps=cfg.train.eval_steps * 10)
        print(metrics)
        return metrics
    if task == "predict":
        from recsys.train.train_state import make_predict_step
        predict = make_predict_step(model)
        probs = [
            np.asarray(predict(params, model_state, b))
            for b in eval_batches()
        ]
        out = np.concatenate(probs)
        print({"num_predictions": len(out), "mean_prob": float(out.mean())})
        return {"probs": out}
    if task == "export":
        from recsys.serve.export import export_servable
        d = export_servable(kv.get("export_dir", "./export"), cfg.model.name,
                            params, model_state, cfg.model, cfg.criteo)
        print({"export_dir": d})
        return {"export_dir": d}
    raise SystemExit(f"unknown task {task}")


if __name__ == "__main__":
    from recsys.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
