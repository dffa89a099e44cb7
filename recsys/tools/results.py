"""RESULTS generator — measures every model family on the current device
and writes RESULTS.md + RESULTS.json at the repo root.

The reference's de-facto integration test is its README metric tables
(README.md:20-28,92-94,115-119; deepfm/readme.md:9-20,57-73). This script is
the regenerable equivalent: one command produces per-model quality
(AUC/logloss on the planted synthetic task — NOT comparable to the
reference's real-Criteo AUC, but a fixed regression target), training and
eval throughput per chip, CF ranking metrics, CDAE success rates, and
serving latency percentiles.

Usage:
    python -m recsys.tools.results \
        [--out=RESULTS.md] [--batch=16384] [--steps=rows/batch] [--rows=8388608] \
        [--serving=1] [--models=fm,deepfm,...]

Default CTR protocol: ONE epoch over 8M distinct synthetic rows (steps ×
batch = rows) at lr 2e-3 — measured as the quality sweet spot; repeated
epochs over fewer rows overfit the rare embedding ids (logloss blows up
while AUC stalls), exactly as on real Criteo.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

log = logging.getLogger("recsys.results")

#: reference throughput (examples/s on 2× GTX 1080 Ti, global_step/s × 256
#: — BASELINE.md; README.md:45,53,61,72,84,104)
REF_EXS = {"fm": 23 * 256, "deepfm": 12 * 256, "dcn": 45 * 256,
           "xdeepfm": 14 * 256, "dnn": 41 * 256, "din": 124 * 256}

CTR_MODELS = ("fm", "deepfm", "dcn", "xdeepfm", "dnn", "wide")

#: per-model lr overrides for the 1-epoch protocol. `wide` runs its native
#: FTRL-proximal (train/optim.for_model), whose alpha operates on BATCH-MEAN
#: gradients here — at batch 16384 the per-coordinate adagrad scale needs an
#: alpha ~2000x an Adam lr (swept 0.05/0.2/1.0/4.0 on the convergence
#: protocol, tools/converge.py PEAK_LR); the old row reused the Adam-scale
#: default and made the FTRL path read as broken (AUC 0.59, VERDICT r4
#: weak #5).
CTR_LR = {"wide": 4.0}

_SYN_CACHE: dict = {}


def _synthetic_cached(rows: int, cfg, start_row: int = 0):
    """Memoize host-side synthesis — every CTR model trains on the same
    rows, and 8M-row numpy generation is ~30 s we only want to pay once."""
    from recsys.data import criteo
    key = (rows, start_row)
    if key not in _SYN_CACHE:
        _SYN_CACHE[key] = criteo.synthetic_criteo(rows, cfg,
                                                  start_row=start_row)
    return _SYN_CACHE[key]


def _sync(x) -> float:
    """Wait for the device by fetching one host value."""
    return float(np.asarray(x).ravel()[0])


def bench_ctr(name: str, *, batch: int, steps: int, rows: int,
              lr: float = 1e-3, seed: int = 0) -> dict:
    """Train a CTR-zoo model on planted synthetic Criteo; return quality +
    steady-state throughput. Same path as bench.py (devgen scan-fused)."""
    import jax.numpy as jnp

    from recsys.core.config import CriteoConfig, ModelConfig
    from recsys.data import criteo
    from recsys.models.api import make_model
    from recsys.train import fast, metrics as M, train_state as TS

    criteo_cfg = CriteoConfig()
    model = make_model(name, criteo_cfg, ModelConfig(name=name))
    lr = CTR_LR.get(name, lr)
    ts, tx = TS.create_train_state(model, seed=seed, learning_rate=lr)

    train_data = _synthetic_cached(rows, criteo_cfg)
    eval_rows = max(8 * batch, 65536)
    eval_data = _synthetic_cached(eval_rows, criteo_cfg, start_row=10 * rows)
    staged = fast.stage_dataset(train_data)
    staged_eval = fast.stage_dataset(eval_data)
    step_fn = fast.make_scanned_train_step_devgen(model, tx, rows, batch)
    eval_fn = fast.make_scanned_eval(model)

    k = 50
    # first call pays the compile; time the rest (steady state)
    ts, loss = step_fn(ts, staged, k)
    _sync(loss)
    calls = max(1, -(-max(steps - k, k) // k))
    t0 = time.perf_counter()
    for _ in range(calls):
        ts, loss = step_fn(ts, staged, k)
    _sync(loss)
    dt = time.perf_counter() - t0
    train_exs = calls * k * batch / dt

    # eval: full coverage of the eval set, timed after compile
    ebs = min(batch, eval_rows)
    n_batches = eval_rows // ebs
    idx = jnp.asarray(
        np.arange(n_batches * ebs).reshape(n_batches, ebs), jnp.int32)
    mstate = eval_fn(ts.params, ts.model_state, staged_eval, idx,
                     M.init_binary_metrics())
    quality = M.finalize_binary_metrics(mstate)
    t0 = time.perf_counter()
    mstate = eval_fn(ts.params, ts.model_state, staged_eval, idx,
                     M.init_binary_metrics())
    _sync(mstate.count)
    eval_exs = n_batches * ebs / (time.perf_counter() - t0)

    out = {
        "model": name, "auc": quality["auc"], "logloss": quality["logloss"],
        "train_examples_per_s": train_exs, "eval_examples_per_s": eval_exs,
        "batch": batch, "steps": (calls + 1) * k,
    }
    if name in REF_EXS:
        out["vs_reference"] = train_exs / REF_EXS[name]
    log.info("%s: auc %.4f logloss %.4f  %.0f train ex/s  %.0f eval ex/s",
             name, out["auc"], out["logloss"], train_exs, eval_exs)
    return out


def bench_din(*, batch: int = 1024, steps: int = 300, seed: int = 0) -> dict:
    """DIN on planted taste-cluster sequences (din/din.py parity model)."""
    import jax.numpy as jnp

    from recsys.core.config import ModelConfig
    from recsys.data import amazon
    from recsys.models.api import make_model
    from recsys.train import fast, metrics as M, train_state as TS

    # hardened task (noisy histories + in-category negatives): planted
    # ceiling ≈0.875, so the reported AUC is a real regression target —
    # the clean task saturated at 0.99 (VERDICT r3 weak #6)
    ds = amazon.synthetic_din_hard(n_users=20_000, item_vocab=2000,
                                   cate_vocab=40, seed=seed)
    model = make_model("din", ds.item_vocab, ds.cate_vocab,
                       ModelConfig(name="din", embedding_dim=16,
                                   dropout=0.1, use_bn=False))
    ts, tx = TS.create_train_state(model, seed=seed, learning_rate=3e-3)
    n = len(ds.label)
    data = {"i_id": ds.i_id, "i_cate": ds.i_cate, "hist_iid": ds.hist_iid,
            "hist_cate": ds.hist_cate, "label": ds.label}
    # single padding bucket (synthetic_din emits one) → devgen path applies
    hold = max(4 * batch, n // 10)
    train = {k: v[:-hold] for k, v in data.items()}
    evald = {k: v[-hold:] for k, v in data.items()}
    staged = fast.stage_dataset(train)
    step_fn = fast.make_scanned_train_step_devgen(
        model, tx, len(train["label"]), batch)

    k = 50
    ts, loss = step_fn(ts, staged, k)
    _sync(loss)
    calls = max(1, -(-max(steps - k, k) // k))
    t0 = time.perf_counter()
    for _ in range(calls):
        ts, loss = step_fn(ts, staged, k)
    _sync(loss)
    train_exs = calls * k * batch / (time.perf_counter() - t0)

    eval_step = TS.make_eval_step(model)
    mstate = M.init_binary_metrics()
    ne = len(evald["label"])
    for lo in range(0, ne - batch + 1, batch):
        b = {kk: jnp.asarray(v[lo:lo + batch]) for kk, v in evald.items()}
        mstate = eval_step(ts.params, ts.model_state, mstate, b)
    quality = M.finalize_binary_metrics(mstate)
    out = {"model": "din", "auc": quality["auc"],
           "logloss": quality["logloss"],
           "train_examples_per_s": train_exs, "batch": batch,
           "vs_reference": train_exs / REF_EXS["din"]}
    log.info("din: auc %.4f  %.0f train ex/s", out["auc"], train_exs)
    return out


def bench_cf(seed: int = 0, workdir: str | None = None) -> list[dict]:
    """VAE-CF family via the product trainer + CDAE — ranking metrics on
    planted synthetic interactions (protocol parity; values are not
    ML-20M-comparable)."""
    from recsys.data import movielens as ML
    from recsys.models import cdae as CDAE
    from recsys.train import metrics as M
    from recsys.train.vae_loop import VaeTrainConfig, train_vae_cf

    workdir = workdir or tempfile.mkdtemp(prefix="recsys_results_")
    u, i, r = ML.synthetic_interactions(n_users=1200, n_items=400, seed=seed)
    data = ML.preprocess_vae_cf(u, i, r, n_heldout_users=150)
    rows = []
    for name in ("multi_vae", "multi_dae", "logistic_vae"):
        cfg = VaeTrainConfig(model=name, latent_dim=32, hidden_dim=128,
                             epochs=25, batch_size=250,
                             total_anneal_steps=2000,
                             model_dir=os.path.join(workdir, name))
        t0 = time.perf_counter()
        res = train_vae_cf(data, cfg)
        rows.append({
            "model": name, "best_val_ndcg@100": res["best_ndcg"],
            "test_ndcg@100": res["test"]["ndcg@100"],
            "test_recall@20": res["test"]["recall@20"],
            "test_recall@50": res["test"]["recall@50"],
            "train_seconds": time.perf_counter() - t0,
        })
        log.info("%s: %s", name, rows[-1])

    users, train_x, _, test_x = ML.synthetic_ml100k(n_users=400, n_items=200,
                                                    seed=seed)
    t0 = time.perf_counter()
    params, apply, _ = CDAE.train_cdae(train_x, users, hidden=32, epochs=40,
                                       batch_size=64)
    sr = {}
    for n_top in (1, 5, 10):
        pred = CDAE.predict_topn(apply, params, train_x, users, n=n_top)
        sr[f"sr@{n_top}"] = M.success_rate_at_n(pred, test_x)
    rows.append({"model": "cdae", **sr,
                 "train_seconds": time.perf_counter() - t0})
    log.info("cdae: %s", rows[-1])
    return rows


def _bench_device_serving_throughput(sv, batcher, cfg, *, batch: int = 8192,
                                     clients: int = 4, reqs: int = 16) -> dict:
    """Saturation-throughput serving on the default device: ``clients``
    concurrent threads keep big batches in flight against the
    micro-batcher, so device dispatches pipeline and the aggregate rate is
    what a ranking tier would see. Reference analog: TF-Serving's batched
    server fed by future-based clients (deepfm/grpc_client.py:57-85)."""
    import threading

    from recsys.data import criteo as _criteo

    feats = _criteo.synthetic_criteo(batch, cfg, start_row=77_000_000)
    feats.pop("label")
    batcher.predict(feats)   # warm the bucket
    done = []
    t0 = time.perf_counter()

    def worker():
        # direct servable calls: each thread keeps its own device call in
        # flight (Servable.predict is thread-safe by contract), so dispatch
        # round-trips overlap — the reference's stub.Predict.future
        # pipelining, server-side
        for _ in range(reqs):
            p = sv.predict(feats)
            done.append(len(p))

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    exs = sum(done) / dt
    import jax
    device = jax.devices()[0].device_kind
    row = {"model": "deepfm-criteo", "device": device,
           "protocol": f"throughput ({clients} clients)", "batch": batch,
           "examples_per_s": exs}
    log.info("%s serving throughput: %.0f ex/s (%d clients x %d reqs "
             "of %d)", device, exs, clients, reqs, batch)
    return row


def _bench_cpu_serving(export_dir: str, model_tag: str,
                       sample_fn, auc_rows: int = 0,
                       engine: str = "jit") -> list[dict]:
    """Latency-mode serving: spawn `train_ctr serve --device=cpu` (its own
    process, held to the CPU backend by JAX_PLATFORMS so it never opens
    the accelerator this process holds) and measure
    p50/p99 — the apples-to-apples rows against the reference's CPU
    TF-Serving numbers (deepfm/readme.md:64-73). ``sample_fn(n)`` yields a
    feature batch + labels; ``auc_rows>0`` adds a served-AUC check over
    that many rows (batched at 512 — large enough that the AUC is not
    small-sample noise). ``engine='numpy'`` serves through the NumPy
    latency engine (serve/numpy_engine.py) and tags its rows."""
    from recsys.serve import client as C
    from recsys.serve.fastsock import SocketClient

    tag = "" if engine == "jit" else f" ({engine})"
    proc = subprocess.Popen(
        [sys.executable, "-m", "recsys.tools.train_ctr", "serve",
         f"--export_dir={export_dir}", "--port=0", "--device=cpu",
         f"--engine={engine}", "--buckets=200,256,500,512"],
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    port = None
    seen: list[str] = []
    try:
        for line in proc.stderr:      # wait for "serving <m> on REST:<port>"
            seen.append(line)
            if "serving" in line and "REST:" in line:
                port = int(line.rsplit("REST:", 1)[1].split()[0])
                break
        if port is None:
            raise RuntimeError(
                "cpu serve process died before binding; stderr tail:\n"
                + "".join(seen[-15:]))
        rows = []
        import importlib.util
        stub = (C.make_grpc_stub(port + 1)
                if importlib.util.find_spec("grpc") else None)
        for n in (200, 500):
            data, labels = sample_fn(n)
            # end-to-end REST: client encode + HTTP + parse every call
            stats = C.benchmark_serving(
                lambda f: C.rest_predict(port, f), data, None,
                warmup=3, iters=50)
            rows.append({**stats, "batch": n, "device": "cpu",
                         "model": model_tag, "protocol": "rest+encode" + tag})
            body = C.prepare_body(data, binary=True)
            if stub is not None:
                # reference-parity gRPC: request pre-built before timing
                # (grpc_client.py:41-54 builds Examples outside the clock)
                stats = C.benchmark_serving(
                    lambda _: C.grpc_send(stub, body), data, None,
                    warmup=3, iters=50)
                rows.append({**stats, "batch": n, "device": "cpu",
                             "model": model_tag,
                             "protocol": "grpc prepared" + tag})
            # framework fast paths: persistent socket, NPZ1 and RAW1 bodies
            sc = SocketClient(port + 2)
            stats = C.benchmark_serving(
                lambda _: sc.send(body), data, None, warmup=3, iters=50)
            rows.append({**stats, "batch": n, "device": "cpu",
                         "model": model_tag, "protocol": "socket npz" + tag})
            raw_body = C.prepare_body(data, fmt="raw")
            stats = C.benchmark_serving(
                lambda _: sc.send(raw_body), data, None, warmup=5, iters=100)
            sc.close()
            rows.append({**stats, "batch": n, "device": "cpu",
                         "model": model_tag, "protocol": "socket raw" + tag})
            log.info("cpu serving %s batch %d: %s", model_tag, n, rows[-3:])
        if auc_rows:
            # served-AUC sanity over a slice big enough to be meaningful
            # (the reference client's check, grpc_client.py:85)
            sc = SocketClient(port + 2)
            probs, ys = [], []
            for _ in range(auc_rows // 512):
                data, labels = sample_fn(512)
                probs.append(sc.send(C.prepare_body(data, fmt="raw")))
                ys.append(labels)
            sc.close()
            from recsys.train.metrics import roc_auc
            auc = float(roc_auc(np.concatenate(ys),
                                      np.concatenate(probs)))
            rows.append({"batch": 512, "device": "cpu", "model": model_tag,
                         "protocol": f"served-AUC ({auc_rows} rows)",
                         "auc": auc})
            log.info("served AUC (%s, %d rows): %.4f", model_tag,
                     auc_rows, auc)
        return rows
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def bench_serving(seed: int = 0, workdir: str | None = None) -> list[dict]:
    """Serving latency at the reference's batch sizes
    (deepfm/readme.md:64-73: 0.29 ms @ 200, 0.36 ms @ 500 on CPU
    TF-Serving), plus a served-AUC check.

    Two servables are measured:
    - the Criteo-39-field DeepFM (briefly TRAINED first so the served-AUC
      column is meaningful), and
    - the u_id/i_id demo-schema DeepFM — the model the reference's own
      latency test served (its TF-Serving numbers come from the 2-feature
      demo export, deepfm/deepfm.py:37-51 + readme.md:64-73), so this is
      the apples-to-apples workload row.
    """
    import threading

    import jax

    from recsys.core.config import CriteoConfig, ModelConfig
    from recsys.data import criteo, demo
    from recsys.models.api import make_model
    from recsys.serve import client as C
    from recsys.serve.export import Servable, export_servable
    from recsys.serve.server import make_rest_server
    from recsys.train import fast, train_state as TS

    cfg = CriteoConfig()
    mcfg = ModelConfig(name="deepfm")
    model = make_model("deepfm", cfg, mcfg)
    workdir = workdir or tempfile.mkdtemp(prefix="recsys_results_")

    # quick training pass so served predictions rank properly (AUC ~0.78+
    # on the planted task instead of random-init noise)
    ts, tx = TS.create_train_state(model, seed=seed, learning_rate=2e-3)
    train_rows = 1 << 22
    ts, _ = fast.train_on_device(
        model, tx, ts, _synthetic_cached(train_rows, cfg),
        batch_size=8192, num_steps=1500, steps_per_call=100)
    params = jax.tree.map(np.asarray, ts.params)
    state = jax.tree.map(np.asarray, ts.model_state)

    d = os.path.join(workdir, "export_deepfm")
    export_servable(d, "deepfm", params, state, mcfg, cfg)
    sv = Servable(d, buckets=(256, 512, 8192))
    sv.warmup()
    server, batcher = make_rest_server(sv, port=0)  # OS-assigned free port
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    rows = []
    try:
        for n in (200, 500):
            data = criteo.synthetic_criteo(n, cfg)
            labels = data.pop("label")
            stats = C.benchmark_serving(
                lambda f: C.rest_predict(port, f), data, None,
                warmup=3, iters=20)
            rows.append({**stats, "batch": n, "model": "deepfm-criteo",
                         "device": jax.devices()[0].device_kind,
                         "protocol": "rest+encode"})
            log.info("serving batch %d: %s", n, stats)
        rows.append(_bench_device_serving_throughput(sv, batcher, cfg))
    finally:
        server.shutdown()

    _eval_row = [20_000_000]

    def criteo_sample(n):
        start = _eval_row[0]
        _eval_row[0] += n
        data = criteo.synthetic_criteo(n, cfg, start_row=start)
        labels = data.pop("label")
        return data, labels

    rows += _bench_cpu_serving(d, "deepfm-criteo", criteo_sample,
                               auc_rows=25600)
    # NumPy latency engine (serve/numpy_engine.py): same servable, zero
    # XLA per-op dispatch — the CPU latency mode
    rows += _bench_cpu_serving(d, "deepfm-criteo", criteo_sample,
                               engine="numpy")

    # demo-schema servable (the reference's serving workload)
    schema = demo.demo_schema()
    demo_model = make_model("deepfm", schema, mcfg)
    dparams, dstate = demo_model.init(jax.random.key(seed))
    dd = os.path.join(workdir, "export_deepfm_demo")
    export_servable(dd, "deepfm", jax.tree.map(np.asarray, dparams),
                    jax.tree.map(np.asarray, dstate), mcfg, schema)

    _demo_seed = [seed]

    def demo_sample(n):
        _demo_seed[0] += 1
        data = demo.synthetic_demo(n, seed=_demo_seed[0], schema=schema)
        labels = data.pop("label")
        return data, labels

    rows += _bench_cpu_serving(dd, "deepfm-demo", demo_sample)
    rows += _bench_cpu_serving(dd, "deepfm-demo", demo_sample,
                               engine="numpy")

    # in-process predict path (numpy engine, no transport): isolates the
    # compute latency from the socket rows' cross-thread scheduling cost
    sv_np = Servable(dd, engine="numpy")
    for n in (200, 500):
        data, _ = demo_sample(n)
        stats = C.benchmark_serving(lambda f: sv_np.predict(f), data,
                                    None, warmup=20, iters=300)
        rows.append({**stats, "batch": n, "device": "cpu",
                     "model": "deepfm-demo",
                     "protocol": "inproc predict (numpy)"})
        log.info("inproc numpy predict batch %d: %s", n, stats)
    return rows


def _md_table(rows: list[dict], cols: list[tuple[str, str, str]]) -> str:
    head = "| " + " | ".join(t for t, _, _ in cols) + " |"
    sep = "|" + "|".join("---" for _ in cols) + "|"
    lines = [head, sep]
    for r in rows:
        cells = []
        for _, key, fmt in cols:
            v = r.get(key)
            cells.append("—" if v is None else format(v, fmt)
                         if fmt else str(v))
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a[2:].split("=", 1) for a in argv
              if a.startswith("--") and "=" in a)
    batch = int(kv.get("batch", 16384))
    rows_n = int(kv.get("rows", 8_388_608))
    steps = int(kv.get("steps", max(1, rows_n // batch)))   # one epoch
    lr = float(kv.get("lr", 2e-3))
    models = kv.get("models", ",".join(CTR_MODELS)).split(",")
    do_serving = kv.get("serving", "1") not in ("0", "false")
    do_cf = kv.get("cf", "1") not in ("0", "false")
    do_din = kv.get("din", "1") not in ("0", "false")
    out_path = kv.get("out", "RESULTS.md")
    workdir = kv.get("workdir") or tempfile.mkdtemp(prefix="recsys_results_")

    import jax
    dev = jax.devices()[0]
    platform = dev.platform
    try:
        commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                                capture_output=True, text=True).stdout.strip()
    except Exception:
        commit = "?"

    result: dict = {"platform": platform, "device": dev.device_kind,
                    "commit": commit, "batch": batch, "steps": steps}
    # partial re-runs (--models=subset / --cf=0 / --din=0 / --serving=0)
    # patch the existing RESULTS.json instead of dropping sections
    json_path = os.path.splitext(out_path)[0] + ".json"
    old: dict = {}
    if os.path.exists(json_path):
        try:
            with open(json_path) as f:
                old = json.load(f)
        except Exception:
            old = {}
    from recsys.data.criteo import synthetic_bayes_metrics
    from recsys.data.synthetic_device import idonly_bayes_metrics
    eval_rows = max(8 * batch, 65536)
    ceiling = synthetic_bayes_metrics(eval_rows, start_row=10 * rows_n)
    idonly = idonly_bayes_metrics(eval_rows, start_row=10 * rows_n)
    result["idonly_ceiling"] = idonly
    result["bayes_ceiling"] = ceiling
    do_ctr = kv.get("ctr", "1") not in ("0", "false")
    new_ctr = ([bench_ctr(m, batch=batch, steps=steps, rows=rows_n, lr=lr)
                for m in models] if do_ctr else [])
    for r in new_ctr:
        r["commit"] = commit
    # Rows carried over from a previous run keep their own per-row commit
    # (stamped when they were measured) so merged tables never claim stale
    # numbers came from HEAD.
    old_rows = [dict(r, commit=r.get("commit", old.get("commit", "?")))
                for r in old.get("ctr", [])]
    by_model = {r["model"]: r for r in old_rows}
    by_model.update({r["model"]: r for r in new_ctr})
    order = [m for m in CTR_MODELS if m in by_model]
    order += [m for m in (r["model"] for r in new_ctr) if m not in order]
    ctr_rows = [by_model[m] for m in order] or new_ctr
    result["ctr"] = ctr_rows
    ctr_rows = ctr_rows + [
        {"model": "(id-only ceiling)", **idonly},
        {"model": "(bayes ceiling)", **ceiling},
    ]
    def _carry(section):
        """Old section + provenance marker: measured at its own commit."""
        sec = old[section]
        if isinstance(sec, dict):
            sec = dict(sec, merged_from=old.get("commit", "?"))
        return sec

    if do_din:
        result["din"] = bench_din(batch=min(batch, 1024),
                                  steps=min(steps, 300))
    elif "din" in old:
        result["din"] = _carry("din")
    if do_cf:
        result["cf"] = bench_cf(workdir=workdir)
    elif "cf" in old:
        result["cf"] = _carry("cf")
    if do_serving:
        result["serving"] = bench_serving(workdir=workdir)
    elif "serving" in old:
        result["serving"] = _carry("serving")
    do_din, do_cf, do_serving = ("din" in result, "cf" in result,
                                 "serving" in result)

    # --- render ---
    md = [
        "# RESULTS — recsys measured numbers",
        "",
        f"Generated by `python -m recsys.tools.results` at commit "
        f"`{commit}` on `{result['device']}` "
        f"({time.strftime('%Y-%m-%d %H:%M UTC', time.gmtime())}).",
        "",
        "Quality numbers are on the repo's planted SECOND-ORDER synthetic "
        "task (fixed seeds; rank-4 all-pairs id interactions — "
        "data/criteo.py SyntheticSpec), so they are regression targets "
        "for THIS framework — not comparable to the reference's "
        "real-dataset AUC. The `(bayes ceiling)` row is the AUC/logloss "
        "of the planted ground-truth probabilities on the same eval "
        "slice — the best any model could do; `(id-only ceiling)` is the "
        "best for models that never see the raw `dense` values (all but "
        "xDeepFM). This table's 1-epoch rows are deliberately short; "
        "`python -m recsys.tools.converge` runs the tuned 400M-example "
        "protocol against THREE ceilings (linear/id-only/full). "
        "Throughput IS "
        "comparable: `vs reference` divides our examples/s/chip by the "
        "reference's 2-GPU examples/s (BASELINE.md).",
        "",
        f"## CTR zoo (synthetic Criteo, 39 fields, emb 16, batch {batch})",
        "",
        "`xdeepfm`'s lower rate is its CIN tower: three CIN layers add "
        "~60 GFLOP of pairwise-interaction compute per 16k batch that no "
        "other zoo model performs (the reference shows the same ordering: "
        "xdeepfm 14 steps/s vs dcn 45, README.md:53,61).",
        "",
        _md_table(ctr_rows, [
            ("model", "model", ""), ("AUC", "auc", ".4f"),
            ("logloss", "logloss", ".4f"),
            ("train ex/s/chip", "train_examples_per_s", ",.0f"),
            ("eval ex/s/chip", "eval_examples_per_s", ",.0f"),
            ("vs reference", "vs_reference", ".1f"),
        ]),
    ]
    if do_din:
        md += ["", "## DIN (synthetic taste-cluster sequences)", "",
               "DIN trains at batch 1024 over ~32 history positions of "
               "[P, D=16] attention inputs per example.", "",
               _md_table([result["din"]], [
                   ("model", "model", ""), ("AUC", "auc", ".4f"),
                   ("logloss", "logloss", ".4f"),
                   ("train ex/s/chip", "train_examples_per_s", ",.0f"),
                   ("batch", "batch", "d"),
                   ("vs reference", "vs_reference", ".1f"),
               ])]
    if do_cf:
        md += ["", "## CF family (synthetic interactions, product trainers)",
               "",
               _md_table([r for r in result["cf"] if r["model"] != "cdae"], [
                   ("model", "model", ""),
                   ("best val NDCG@100", "best_val_ndcg@100", ".4f"),
                   ("test NDCG@100", "test_ndcg@100", ".4f"),
                   ("test Recall@20", "test_recall@20", ".4f"),
                   ("test Recall@50", "test_recall@50", ".4f"),
                   ("train s", "train_seconds", ".1f"),
               ]),
               "",
               _md_table([r for r in result["cf"] if r["model"] == "cdae"], [
                   ("model", "model", ""), ("SR@1", "sr@1", ".2f"),
                   ("SR@5", "sr@5", ".2f"), ("SR@10", "sr@10", ".2f"),
                   ("train s", "train_seconds", ".1f"),
               ])]
    if do_serving:
        md += ["", "## Serving (reference: 0.29 ms @ 200 / 0.36 ms @ 500 on "
               "TF-Serving CPU, serving the 2-feature u_id/i_id demo "
               "DeepFM — the `deepfm-demo` rows are that workload; "
               "`deepfm-criteo` serves the full 39-field model and its "
               "served-AUC row is checked over 25,600 rows)", "",
               "The reference's 0.29 ms was measured on its author's "
               "multi-core CPU host. `cpu` rows serve from a child process "
               "on the host CPU; the `throughput` row keeps 4 pipelined "
               "client calls in flight on the default device.", "",
               _md_table(result["serving"], [
                   ("model", "model", ""),
                   ("device", "device", ""),
                   ("protocol", "protocol", ""),
                   ("batch", "batch", "d"),
                   ("p50 ms", "latency_ms_p50", ".2f"),
                   ("p99 ms", "latency_ms_p99", ".2f"),
                   ("mean ms", "latency_ms_mean", ".2f"),
                   ("ex/s", "examples_per_s", ",.0f"),
                   ("AUC", "auc", ".4f"),
               ])]
    md.append("")

    with open(out_path, "w") as f:
        f.write("\n".join(md))
    with open(json_path, "w") as f:
        json.dump(result, f, indent=1)
    log.info("wrote %s and %s", out_path, json_path)
    return result


if __name__ == "__main__":
    main()
