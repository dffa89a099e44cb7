"""Convergence-quality protocol: train the CTR zoo to the planted ceiling.

The reference's correctness claim is metric parity on real Criteo
(README.md:20-28 — e.g. FM hits its paper AUC exactly). This repo's quality
claim is the analog on the planted synthetic task: train until the gap to
the task's *attainable* ceiling is small, proving the models and training
stack converge — not just that they're fast.

Protocol (per model):
- one-pass online SGD on FRESH samples drawn on device every step
  (data/synthetic_device.make_device_sampler fused into the training scan)
  — the infinite-data regime: no epoch reuse, no overfitting, the
  optimization target IS the population risk;
- Adam with linear warmup + cosine decay to 0 over the example budget
  (the final AUC millipoints come from shrinking the Adam noise ball);
- dropout off by default (it regularizes against overfitting that cannot
  happen with fresh samples; the 1-epoch RESULTS protocol keeps the
  reference's 0.5);
- eval on a held-out host-generated slice (start_row=1e9) scored against
  BOTH ceilings: the full Bayes ceiling (criteo.synthetic_bayes_metrics)
  and the id-only ceiling (synthetic_device.idonly_bayes_metrics) — the
  best possible for models that never see the raw `dense` values (all but
  xDeepFM, whose linear branch consumes them, xdeepfm/xdeepfm.py:82).

Writes CONVERGENCE.md + CONVERGENCE.json at the repo root.

Usage:
    python -m recsys.tools.converge [--models=deepfm,dcn,...]
        [--examples=200000000] [--batch=16384] [--lr=0.003]
        [--eval_rows=1048576] [--dropout=0.0] [--out=CONVERGENCE.md]
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

log = logging.getLogger("recsys.converge")

#: "wide" trains with Adam (the hypothesis-class-saturation row: its job in
#: the table is to show an additive model pinned AT the linear ceiling);
#: "wide_ftrl" is the same model under its native FTRL-proximal optimizer
#: (reference LinearClassifier parity) — FTRL sees batch-MEAN gradients
#: here (the reference updates per example), so its per-coordinate adagrad
#: scale converges slower at batch 16384; the row documents that honestly.
DEFAULT_MODELS = ("wide", "wide_ftrl", "fm", "deepfm", "dcn", "xdeepfm",
                  "dnn")
EVAL_START_ROW = 1_000_000_000   # disjoint from every RESULTS/test slice

#: per-model peak lr at batch 16384 (swept at 50M examples: deepfm
#: 1.5e-3→0.8535, 3e-3→0.8567, 6e-3→0.8573; xdeepfm 3e-3→0.8590,
#: 6e-3→0.8597 — 6e-3 best and stable for every model). wide_ftrl alpha
#: swept 0.05/0.2/1.0/4.0 at 30M examples: 4.0 best (0.7815) and still
#: shy of the ceiling — see DEFAULT_MODELS note.
PEAK_LR = {"fm": 6e-3, "deepfm": 6e-3, "dcn": 6e-3, "xdeepfm": 6e-3,
           "dnn": 6e-3, "wide": 6e-3, "wide_ftrl": 4.0}


def _sync(x) -> float:
    return float(np.asarray(x).ravel()[0])


def converge_ctr(name: str, *, examples: int, batch: int,
                 lr: float | None = None, dropout: float = 0.0,
                 eval_rows: int = 1 << 20, seed: int = 0,
                 log_every_calls: int = 20,
                 eval_data: dict | None = None) -> dict:
    """Train ``name`` on ``examples`` fresh device-sampled rows, cosine lr
    decay to 0; return final eval quality + protocol metadata."""
    import jax
    import jax.numpy as jnp

    from recsys.core.config import CriteoConfig, ModelConfig
    from recsys.data import criteo, synthetic_device as sd
    from recsys.models.api import make_model
    from recsys.train import fast, metrics as M, optim, train_state as TS

    use_ftrl = name == "wide_ftrl"
    model_name = "wide" if use_ftrl else name
    criteo_cfg = CriteoConfig()
    model_cfg = ModelConfig(name=model_name, dropout=dropout)
    model = make_model(model_name, criteo_cfg, model_cfg)

    # steps per dispatch; total rounds UP to a multiple so every call has
    # the same static k (a second k value would recompile the fused scan)
    k = 200
    total_steps = -(-examples // (batch * k)) * k
    peak = lr if lr is not None else PEAK_LR.get(name, 3e-3)
    warmup = max(200, total_steps // 50)
    if use_ftrl:
        # wide's native optimizer (reference LinearClassifier default,
        # deep&wide/deep&wide.py:146-149): per-coordinate adaptive lr,
        # no external schedule (see DEFAULT_MODELS note on batch-mean
        # gradient scaling)
        opt = optim.ftrl(alpha=peak, l1=0.0, l2=0.0)
        warmup = 0
    else:
        schedule = optim.cosine_decay(peak, total_steps, warmup_steps=warmup)
        opt = optim.adam(schedule)
    ts, tx = TS.create_train_state(model, seed=seed, learning_rate=peak,
                                  opt=opt)

    sampler = sd.make_device_sampler(criteo_cfg)
    tables = {k: jnp.asarray(v)
              for k, v in sd.planted_tables(criteo_cfg).items()}
    step_fn = fast.make_scanned_train_step_sampler(model, tx, sampler, batch)

    if eval_data is None:
        eval_data = criteo.synthetic_criteo(eval_rows, criteo_cfg,
                                            start_row=EVAL_START_ROW)
    staged_eval = fast.stage_dataset(eval_data)
    eval_fn = fast.make_scanned_eval(model)
    ebs = min(batch, eval_rows)
    n_eb = eval_rows // ebs
    eval_idx = jnp.asarray(
        np.arange(n_eb * ebs).reshape(n_eb, ebs), jnp.int32)

    def run_eval(ts):
        mstate = eval_fn(ts.params, ts.model_state, staged_eval, eval_idx,
                         M.init_binary_metrics())
        return M.finalize_binary_metrics(mstate)

    log.info("%s: compiling fused sample+train scan (k=%d) ...", name, k)
    tc = time.perf_counter()
    step_fn.lower(ts, tables, k).compile()   # AOT: keep compile out of ex/s
    compile_s = time.perf_counter() - tc
    log.info("%s: compiled in %.0f s", name, compile_s)

    done = 0
    calls = 0
    t0 = time.perf_counter()
    loss = None
    while done < total_steps:
        ts, loss = step_fn(ts, tables, k)
        done += k
        calls += 1
        if calls % log_every_calls == 0:
            l = _sync(loss)
            dt = time.perf_counter() - t0
            log.info("%s step %d/%d loss %.5f  %.0f ex/s", name, done,
                     total_steps, l, done * batch / dt)
    final_loss = _sync(loss) if loss is not None else float("nan")
    train_dt = time.perf_counter() - t0

    quality = run_eval(ts)
    out = {
        "model": name, "auc": quality["auc"], "logloss": quality["logloss"],
        "examples": done * batch, "batch": batch, "peak_lr": peak,
        "warmup_steps": warmup, "dropout": dropout,
        "final_loss": final_loss, "train_seconds": round(train_dt, 1),
        "compile_seconds": round(compile_s, 1),
        "train_examples_per_s": round(done * batch / train_dt),
        "eval_rows": eval_rows,
    }
    log.info("%s FINAL: auc %.4f logloss %.4f (%.0f s, %.0f ex/s)", name,
             quality["auc"], quality["logloss"], train_dt,
             out["train_examples_per_s"])
    return out


def main(argv: list[str]) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    kv = dict(a.lstrip("-").split("=", 1) for a in argv if "=" in a)
    models = tuple(kv.get("models", ",".join(DEFAULT_MODELS)).split(","))
    examples = int(float(kv.get("examples", 2e8)))
    batch = int(kv.get("batch", 16384))
    lr = float(kv["lr"]) if "lr" in kv else None
    dropout = float(kv.get("dropout", 0.0))
    eval_rows = int(float(kv.get("eval_rows", 1 << 20)))
    out_path = kv.get("out", "CONVERGENCE.md")

    from recsys.core.config import CriteoConfig
    from recsys.data import criteo, synthetic_device as sd

    cfg = CriteoConfig()
    try:
        commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                                capture_output=True, text=True).stdout.strip()
    except Exception:
        commit = "?"

    log.info("generating %d-row eval slice + ceilings ...", eval_rows)
    eval_data = criteo.synthetic_criteo(eval_rows, cfg,
                                        start_row=EVAL_START_ROW)
    ceiling = criteo.synthetic_bayes_metrics(eval_rows, cfg,
                                             start_row=EVAL_START_ROW)
    idonly = sd.idonly_bayes_metrics(eval_rows, cfg,
                                     start_row=EVAL_START_ROW)
    linear = sd.linear_bayes_metrics(eval_rows, cfg,
                                     start_row=EVAL_START_ROW)
    log.info("bayes ceiling auc %.4f ll %.4f | id-only auc %.4f ll %.4f | "
             "linear auc %.4f ll %.4f",
             ceiling["auc"], ceiling["logloss"], idonly["auc"],
             idonly["logloss"], linear["auc"], linear["logloss"])

    rows = []
    for name in models:
        rows.append(converge_ctr(name, examples=examples, batch=batch,
                                 lr=lr, dropout=dropout,
                                 eval_rows=eval_rows, eval_data=eval_data))

    result = {
        "commit": commit, "examples": examples, "batch": batch,
        "eval_rows": eval_rows, "eval_start_row": EVAL_START_ROW,
        "bayes_ceiling": ceiling, "idonly_ceiling": idonly,
        "linear_ceiling": linear,
        "models": rows,
    }

    # attainable ceiling per hypothesis class: additive models → linear;
    # id-consuming interaction models → id-only; dense-consuming → full
    # (see synthetic_device.py module docstring)
    sees_dense = {"xdeepfm"}
    additive = {"wide", "wide_ftrl"}
    gap_full_lin = ceiling["auc"] - linear["auc"]
    lines = [
        "# CONVERGENCE — trained quality vs the planted ceilings",
        "",
        f"Generated by `python -m recsys.tools.converge` at commit "
        f"`{commit}` "
        f"({time.strftime('%Y-%m-%d %H:%M UTC', time.gmtime())}).",
        "",
        f"Protocol: one-pass online training on **{examples:,} fresh rows** "
        f"of the planted **second-order** synthetic-Criteo distribution "
        "(`data/criteo.py SyntheticSpec`: per-id first-order effects + "
        "rank-4 all-pairs id-interaction latents + linear dense), sampled "
        f"on device every step (`data/synthetic_device.py`), batch {batch}, "
        "Adam with linear warmup + cosine decay to 0 (wide: native FTRL), "
        f"dropout {dropout}. Eval on a held-out {eval_rows:,}-row slice "
        f"(start_row={EVAL_START_ROW:,}).",
        "",
        "Three ceilings on this slice (`synthetic_device.py` docstring):",
        "",
        f"- **linear (additive)**: AUC {linear['auc']:.4f} / logloss "
        f"{linear['logloss']:.4f} — best per-(field,id) additive model "
        "(wide/LinearClassifier's hypothesis class, which reads no dense "
        "input); provably cannot represent the planted pairwise term.",
        f"- **id-only**: AUC {idonly['auc']:.4f} / logloss "
        f"{idonly['logloss']:.4f} — E[y | ids], best for models consuming "
        "only the 39 ids (fm, deepfm, dcn, dnn).",
        f"- **Bayes (full)**: AUC {ceiling['auc']:.4f} / logloss "
        f"{ceiling['logloss']:.4f} — true probabilities; needs the raw "
        "dense values (only xDeepFM's linear branch reads them, "
        "xdeepfm/xdeepfm.py:82).",
        "",
        f"**Interaction gap** (full − linear) = "
        f"{gap_full_lin:.4f} AUC: the share of the task that additive "
        "models cannot learn. `closure` below = (trained − linear) / "
        "(full − linear) — how much of that gap each architecture "
        "recovers; the analog of the reference's real-Criteo model "
        "ordering (/root/reference/README.md:20-28).",
        "",
        "| model | AUC | logloss | ceiling | gap (AUC) | gap (logloss) | "
        "closure | peak lr | ex/s | train s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["model"] in sees_dense:
            ceil, which = ceiling, "bayes"
        elif r["model"] in additive:
            ceil, which = linear, "linear"
        else:
            ceil, which = idonly, "id-only"
        closure = (r["auc"] - linear["auc"]) / max(gap_full_lin, 1e-9)
        r["ceiling"] = which
        r["gap_auc"] = ceil["auc"] - r["auc"]
        r["closure"] = closure
        lines.append(
            f"| {r['model']} | {r['auc']:.4f} | {r['logloss']:.4f} "
            f"| {which} | {ceil['auc'] - r['auc']:+.4f} "
            f"| {r['logloss'] - ceil['logloss']:+.4f} "
            f"| {closure:+.0%} "
            f"| {r['peak_lr']:g} | {r['train_examples_per_s']:,} "
            f"| {r['train_seconds']:.0f} |")
    lines += [
        "",
        "Gap (AUC) = attainable ceiling − trained AUC (smaller is better; "
        "negative would be eval-slice noise). Gap (logloss) = trained − "
        "ceiling. closure ≈ 0% means the model learned only the additive "
        "structure (expected for `wide`); 100% means it recovered the "
        "full planted interaction term.",
        "",
    ]
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump(result, f, indent=1)
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    log.info("wrote %s", out_path)


if __name__ == "__main__":
    from recsys.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(sys.argv[1:])
