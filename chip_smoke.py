"""On-card smoke test: drives the main path once on a GPU and checks it.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the SPMD path only

One-GPU phases, in order (any failure exits non-zero before the last line):

1. device: the default device must be a GPU; prints JAX's version, the
   device kind, the card's name and power limit (nvidia-smi) and the
   compile-cache directory;
2. reference checks at bench widths (batch 16384, the full Criteo config):
   the big-field gathers and their scatter-add gradients against a float64
   NumPy oracle, the split engine's small-field matmul against a plain
   gather, the CIN tower against the split-matmul/conv formulation, and a
   DeepFM step at default precision against the same step at "highest";
   the gather and CIN are also timed forward + backward;
3. training through the CLIs: DeepFM to eval AUC >= 0.78 on the planted
   task, then fm, dcn, xdeepfm, dnn, wide and DIN for a few steps each;
4. serving: export the DeepFM checkpoint, load it into a Servable on the
   GPU, start the REST and socket (and gRPC where grpcio imports) servers
   on threads of this process, and compare served probabilities with
   in-process predict;
5. the steady DeepFM training rate of `bench.py`.

The last line of standard output is one JSON object naming the device;
every number printed before it carries the card's name and power limit.
Scratch state (synthetic shards, checkpoints, exports, profiler traces and
the CIN HLO) goes to the git-ignored ``.smoke/``, emptied at start.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
OUT = os.path.join(WORK, "out")

#: float32 / TF32 / bfloat16 unit roundoff (round to nearest)
U_F32 = 2.0 ** -24
U_TF32 = 2.0 ** -11
U_BF16 = 2.0 ** -9

#: device memory bandwidth by JAX device_kind (NVIDIA's H100 SXM data
#: sheet); a card missing here is an error, not a default
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

CARD = "?"


def require_gpu(count: int = 1):
    """The first device, or SystemExit unless JAX's default devices are at
    least ``count`` GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default device is "
                         f"{devices[0].platform} ({devices[0].device_kind})")
    if len(devices) < count:
        raise SystemExit(f"needs {count} GPUs; JAX sees {len(devices)}")
    return devices[0]


def last_line(device, count: int) -> str:
    """The closing JSON line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}})


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def report(msg: str) -> None:
    print(f"{msg}  [{CARD}]", flush=True)


def check(name: str, err: float, tol: float, precision: str) -> None:
    """Print one reference check; raise if the error exceeds its bound."""
    ok = err <= tol
    report(f"check {name}: max err {err:.3e} <= tol {tol:.3e} "
           f"({precision}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max err {err} > tol {tol}")


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over all elements."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def tf32_tol(k: int, layers: int) -> float:
    """Error bound, relative to the largest output, of ``layers`` stacked
    f32 matmuls with contractions of up to ``k`` terms when each operand is
    rounded to TF32 (u = 2^-11): each product moves by at most 2u relative,
    K such errors of random sign add up to 2u·sqrt(K) of the terms' scale,
    and each stacked layer adds its own."""
    return 2 * layers * U_TF32 * math.sqrt(k)


def time_fn(fn, *args, iters: int = 20):
    """(median host seconds per call, device seconds per call, kernels) of a
    jitted ``fn``; each call ends in block_until_ready. Device time and the
    kernels ([name, ms per call, launches per call], longest first) come
    from a trace of three calls."""
    import jax

    from recsys.utils import profiling

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    trace_dir = os.path.join(OUT, "traces", fn.__name__)
    shutil.rmtree(trace_dir, ignore_errors=True)
    n_traced = 3
    with jax.profiler.trace(trace_dir):
        for _ in range(n_traced):
            jax.block_until_ready(fn(*args))
    rows = profiling.device_breakdown(trace_dir, top=1000)
    if not rows:
        raise RuntimeError(f"no device events in the trace of {fn.__name__}")
    kernels = [(r["op"], r["total_ms"] / n_traced, r["count"] // n_traced)
               for r in rows]
    device_s = sum(ms for _, ms, _ in kernels) / 1e3
    return float(np.median(times)), device_s, kernels


def report_kernels(kernels, top: int) -> None:
    for name, ms, launches in kernels[:top]:
        report(f"  kernel {name[:60]}: {ms:.4f} ms/call x{launches}")


# ---------------------------------------------------------------------------
# Phase 2: reference checks
# ---------------------------------------------------------------------------

def _zipf_ids(rng, vocab_sizes, batch: int) -> np.ndarray:
    """[batch, F] field-local ids with heavy duplicates (Zipf, a=1.2)."""
    cols = [(rng.zipf(1.2, batch) - 1) % v for v in vocab_sizes]
    return np.stack(cols, axis=1).astype(np.int32)


def _criteo_engine():
    """The default split engine over the full Criteo feature config."""
    from recsys.core.config import CriteoConfig, EmbeddingConfig
    from recsys.embeddings import engines

    return engines.SplitEngine(EmbeddingConfig(
        field_vocab_sizes=CriteoConfig().field_vocab_sizes,
        embedding_dim=16))


def check_gathers(batch: int) -> None:
    import jax
    import jax.numpy as jnp

    from recsys.embeddings import table

    eng = _criteo_engine()
    _, big = eng._partition()
    sizes = eng._sizes(big)
    w = eng.width
    v_pad = table.pad_rows(sum(sizes))
    rng = np.random.default_rng(0)
    gids = _zipf_ids(rng, sizes, batch) + table.field_offsets(sizes)[None, :]
    flat = gids.reshape(-1)
    n = flat.size
    tab = rng.standard_normal((v_pad, w)).astype(np.float32)
    ct = rng.standard_normal((n, w)).astype(np.float32)

    # float64 oracle: forward rows and the scatter-add of the cotangent
    want_rows = tab[flat]
    want_grad = np.zeros((v_pad, w), np.float64)
    np.add.at(want_grad, flat, ct.astype(np.float64))
    abs_sum = np.zeros((v_pad, w), np.float64)
    np.add.at(abs_sum, flat, np.abs(ct).astype(np.float64))
    dup = np.bincount(flat, minlength=v_pad).astype(np.float64)[:, None]
    # recursive f32 summation in any order (atomics included): the error
    # of a sum of k terms is at most γ·Σ|terms| with γ = (k-1)·u/(1-(k-1)·u),
    # a bound that a sum of two same-sign terms comes within 2^-24 of
    ku = np.maximum(dup - 1, 0) * U_F32
    bound = ku / (1 - ku) * abs_sum + 1e-30
    report(f"gather: {n} ids ({batch} x {len(sizes)} big fields) into "
           f"{v_pad} rows x {w}; max duplicates of one row {int(dup.max())}")

    layouts = {
        "table_gather_wm": (table.table_gather_wm, jnp.asarray(tab.T),
                            jnp.asarray(flat), lambda g: np.asarray(g).T),
        "table_gather": (table.table_gather, jnp.asarray(tab),
                         jnp.asarray(gids), np.asarray),
        "table_gather_flat": (
            lambda t, i: table.table_gather_flat(t, i, v_pad, w),
            jnp.asarray(tab.reshape(-1)), jnp.asarray(gids),
            lambda g: np.asarray(g).reshape(v_pad, w)),
    }
    ct_j = jnp.asarray(ct)
    for name, (fn, t, ids, to_rows) in layouts.items():
        def fwd_bwd(t, ids, ct, fn=fn):
            rows, vjp = jax.vjp(lambda tt: fn(tt, ids), t)
            return rows, vjp(ct.reshape(rows.shape))[0]

        fwd_bwd.__name__ = name
        fwd_bwd = jax.jit(fwd_bwd)
        rows, grad = fwd_bwd(t, ids, ct_j)
        rows = np.asarray(rows).reshape(n, w)
        check(f"{name} forward", float(np.max(np.abs(rows - want_rows))),
              0.0, "f32 gather: exact")
        ratio = np.abs(to_rows(grad) - want_grad) / bound
        check(f"{name} gradient (err / γ_(k-1)·Σ|g| bound)",
              float(ratio.max()), 1.0,
              "f32 scatter-add, any summation order")
        if name == "table_gather_wm":
            host_s, dev_s, kernels = time_fn(fwd_bwd, t, ids, ct_j)
            # least bytes a forward + backward must move: read ids and rows,
            # write rows; read the cotangent and ids, write the whole
            # gradient table, read-modify-write each touched gradient row
            nbytes = 4 * (2 * n + 5 * n * w + v_pad * w)
            peak = HBM_BYTES_PER_S[jax.devices()[0].device_kind]
            report(f"time table_gather_wm fwd+bwd: host median "
                   f"{host_s * 1e3:.3f} ms, device {dev_s * 1e3:.4f} ms; "
                   f"{nbytes / 1e6:.1f} MB -> {nbytes / dev_s / 1e9:.1f} GB/s"
                   f" = {nbytes / dev_s / peak:.1%} of {peak / 1e12} TB/s")
            report_kernels(kernels, 5)


def check_small_fields(batch: int) -> None:
    import jax
    import jax.numpy as jnp

    eng = _criteo_engine()
    small, _ = eng._partition()
    params = eng.init(jax.random.key(0))
    rng = np.random.default_rng(1)
    ids = jnp.asarray(np.stack(
        [rng.integers(0, v, batch) for v in eng.cfg.field_vocab_sizes],
        axis=1).astype(np.int32))
    d = eng.cfg.embedding_dim

    @jax.jit
    def both(table, ids):
        emb2, wide = eng._small_parts(table, ids, small, train=True)
        rows = eng._small_rows_gather(table, ids, small)
        return emb2, wide, rows

    emb2, wide, rows = both(params["small"], ids)
    rows = np.asarray(rows)
    want = np.concatenate(
        [rows[:, :, :d].reshape(batch, -1), rows[:, :, d]], axis=1)
    got = np.concatenate([np.asarray(emb2), np.asarray(wide)], axis=1)
    # one conversion of each table value to bf16, times a one-hot 1.0
    # summed in f32; XLA's GPU GEMM fusion may convert by truncation, so
    # the bound is one bf16 ulp: |err| <= 2·u_bf16·|value|
    ratio = np.abs(got - want) / (2 * U_BF16 * np.abs(want) + 1e-30)
    check("split small-field matmul vs gather (err / 2·u_bf16·|x|)",
          float(ratio.max()), 1.0, "bf16 one-hot matmul, f32 accumulate")


def cin_reference(params, x0):
    """CIN as the reference computes it (xdeepfm/xdeepfm.py:145-181): per
    embedding dim the [F0, Fk] outer product, a 'conv1d' with [F0·Fk, H]
    filters at flat index p·Fk+q, relu, sum-pool over D."""
    import jax
    import jax.numpy as jnp

    b, f0, d = x0.shape
    xk = x0
    pooled = []
    for layer in params:
        outer = jnp.einsum("bpd,bqd->bdpq", x0, xk)
        z = outer.reshape(b, d, -1)
        nxt = jax.nn.relu(jnp.einsum("bdk,kh->bhd", z, layer["w"])
                          + layer["b"][None, :, None])
        xk = nxt
        pooled.append(jnp.sum(nxt, axis=2))
    return jnp.concatenate(pooled, axis=1)


def _z_buffers(hlo_text: str, z_elems: set[int]) -> list[str]:
    """Top-level (ENTRY) instructions whose result has exactly as many
    elements as a CIN layer's z = [B·D, F0·Fk]: buffers of that size are
    written to device memory."""
    import re

    entry = hlo_text[hlo_text.index("\nENTRY"):]
    entry = entry[:entry.index("\n}")]
    found = []
    for line in entry.splitlines()[1:]:
        if " = " not in line:
            continue
        name, rhs = line.strip().removeprefix("ROOT ").split(" = ", 1)
        # the result type: one array type, or a parenthesized tuple of them
        rtype = (rhs[:rhs.index(") ") + 1] if rhs.startswith("(")
                 else rhs.split(" ", 1)[0])
        op = rhs[len(rtype):].split("(", 1)[0].strip()
        kind = re.search(r"kind=(\w+)", rhs)
        for dtype, dims in re.findall(r"(\w+)\[([\d,]+)\]", rtype):
            if math.prod(int(x) for x in dims.split(",")) in z_elems:
                found.append(f"{name} {dtype}[{dims}] {op}"
                             f"{' ' + kind.group(1) if kind else ''}")
    return found


def check_cin(batch: int) -> None:
    import jax
    import jax.numpy as jnp

    from recsys.core.config import CriteoConfig, ModelConfig
    from recsys.ops import interactions

    f0, d = len(CriteoConfig().field_vocab_sizes), 16
    layers = ModelConfig().cin_layers
    params = interactions.cin_init(jax.random.key(0), f0, layers)
    x0 = jax.random.normal(jax.random.key(1), (batch, f0, d), jnp.float32)
    w_out = jax.random.normal(jax.random.key(2), (sum(layers),))

    got = jax.jit(interactions.cin_apply_xla)(params, x0)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(cin_reference)(params, x0)
    k_max = f0 * max((f0,) + layers[:-1])
    check(f"cin_apply_xla B={batch} D={d} {layers} (rel to max|out|)",
          rel_err(got, want), tf32_tol(k_max, len(layers)),
          "default (TF32) vs highest-precision reference")

    def loss(p, x):
        return jnp.sum(interactions.cin_apply_xla(p, x) * w_out)

    def cin_fwd_bwd(p, x):
        return jax.value_and_grad(loss, argnums=(0, 1))(p, x)

    cin_fwd_bwd = jax.jit(cin_fwd_bwd)
    hlo = cin_fwd_bwd.lower(params, x0).compile().as_text()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "cin_fwd_bwd_hlo.txt"), "w") as f:
        f.write(hlo)
    z_elems, fk = set(), f0
    for h in layers:
        z_elems.add(batch * d * f0 * fk)
        fk = h
    zbufs = _z_buffers(hlo, z_elems)
    report(f"cin fwd+bwd: {len(zbufs)} z-sized [B*D, F0*Fk] buffers at top "
           f"level (written to HBM): {zbufs}")
    host_s, dev_s, kernels = time_fn(cin_fwd_bwd, params, x0, iters=10)
    gemm_ms = sum(ms for name, ms, _ in kernels if "gemm" in name)
    report(f"time cin_apply_xla fwd+bwd B={batch}: host median "
           f"{host_s * 1e3:.3f} ms, device {dev_s * 1e3:.3f} ms, of which "
           f"GEMM kernels {gemm_ms:.3f} ms")
    report_kernels(kernels, 6)


def check_deepfm(batch: int) -> None:
    import jax

    from recsys.core.config import CriteoConfig, ModelConfig
    from recsys.data import criteo
    from recsys.models.api import make_model
    from recsys.train.train_state import sigmoid_ce

    cfg = CriteoConfig()
    model = make_model("deepfm", cfg, ModelConfig())
    params, mstate = model.init(jax.random.key(0))
    batch_d = {k: jax.numpy.asarray(v)
               for k, v in criteo.synthetic_criteo(batch, cfg).items()}
    rng = jax.random.key(3)

    def step(p):
        def loss(p):
            logits, _ = model.apply(p, mstate, batch_d, train=True, rng=rng)
            return sigmoid_ce(logits, batch_d["label"]), logits
        return jax.value_and_grad(loss, has_aux=True)(p)

    (l_def, logits_def), g_def = jax.jit(step)(params)
    with jax.default_matmul_precision("highest"):
        (l_hi, logits_hi), g_hi = jax.jit(step)(params)
    # the widest contraction is the first dense layer, K = 39·16 = 624,
    # and three dense layers stack (100, 100, 1)
    tol = tf32_tol(len(cfg.field_vocab_sizes) * 16, 3)
    check("deepfm logits (rel to max|logit|)", rel_err(logits_def, logits_hi),
          tol, "default (TF32) vs highest")
    # each leaf's error relative to the largest gradient of its tower (the
    # top-level parameter group): a dense bias followed by batch norm has
    # an exactly zero gradient (the normalization removes any shift), so
    # its own scale is rounding noise
    paths = jax.tree_util.tree_leaves_with_path(g_hi)
    scale: dict = {}
    for path, b in paths:
        scale[path[0]] = max(scale.get(path[0], 0.0),
                             float(np.max(np.abs(b))))
    errs = {}
    for (path, b), a in zip(paths, jax.tree.leaves(g_def)):
        diff = np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b)))
        errs[jax.tree_util.keystr(path)] = float(diff) / max(
            scale[path[0]], 1e-30)
    leaf = max(errs, key=errs.get)
    check(f"deepfm gradients (worst leaf {leaf}, rel to its tower's "
          f"max|grad|)", errs[leaf], tol, "default (TF32) vs highest")
    report(f"deepfm loss default {float(l_def):.6f} highest {float(l_hi):.6f}")


# ---------------------------------------------------------------------------
# Phases 3-5: CLI training, serving, steady rate
# ---------------------------------------------------------------------------

def _ctr_args(name: str, steps: int, **extra) -> list[str]:
    args = ["train", "--mesh.data_axis=1", f"--model.name={name}",
            "--train.batch_size=4096", f"--train.num_steps={steps}",
            f"--train.eval_every_steps={steps}",
            f"--train.model_dir={os.path.join(WORK, 'model_' + name)}"]
    return args + [f"--{k}={v}" for k, v in extra.items()]


def train_models() -> None:
    from recsys.tools import train_ctr, train_din

    # 500 steps over 8M rows: the sampler draws mostly unseen rows (one
    # pass); 250 steps over the default 2M rows end near AUC 0.77
    m = train_ctr.main(_ctr_args("deepfm", 500, **{
        "train.eval_steps": 20, "train.learning_rate": 0.003,
        "synthetic_rows": 8_000_000}))
    report(f"train deepfm 500 steps: eval auc {m['auc']:.4f} (need >= 0.78), "
           f"final loss {m['final_loss']:.5f}")
    if not m["auc"] >= 0.78:
        raise AssertionError(f"deepfm eval auc {m['auc']} < 0.78")
    for name in ("fm", "dcn", "xdeepfm", "dnn", "wide"):
        m = train_ctr.main(_ctr_args(name, 20, **{"train.eval_steps": 2}))
        report(f"train {name} 20 steps: final loss {m['final_loss']:.5f}, "
               f"eval auc {m['auc']:.4f}")
        if not np.isfinite(m["final_loss"]):
            raise AssertionError(f"{name}: non-finite loss")
    m = train_din.main([
        "train", "--train.batch_size=1024", "--train.num_steps=20",
        "--train.eval_every_steps=20", "--train.eval_steps=2",
        "--train.log_every_steps=10", "--synthetic_users=4000",
        f"--train.model_dir={os.path.join(WORK, 'model_din')}"])
    report(f"train din 20 steps: final loss {m['final_loss']:.5f}, "
           f"eval auc {m['auc']:.4f}")
    if not np.isfinite(m["final_loss"]):
        raise AssertionError("din: non-finite loss")


def serve() -> None:
    import jax

    from recsys.core.config import CriteoConfig, ModelConfig
    from recsys.data import criteo
    from recsys.models.api import make_model
    from recsys.core.checkpoint import CheckpointManager
    from recsys.serve import client as C
    from recsys.serve.export import Servable
    from recsys.serve.fastsock import SocketClient
    from recsys.serve.server import start_servers
    from recsys.tools import train_ctr
    from recsys.train.train_state import create_train_state, make_predict_step

    model_dir = os.path.join(WORK, "model_deepfm")
    export_dir = os.path.join(WORK, "export_deepfm")
    train_ctr.main(["export", "--model.name=deepfm",
                    f"--train.model_dir={model_dir}",
                    f"--export_dir={export_dir}"])
    sv = Servable(export_dir, buckets=(256, 1024))
    sv.warmup()
    placed = jax.tree.leaves(sv.params)[0].devices()
    report(f"servable params on {sorted(str(d) for d in placed)}")

    # in-process predict from the training checkpoint, independent of the
    # export and the servers
    cfg = CriteoConfig()
    model = make_model("deepfm", cfg, ModelConfig())
    ts, _ = create_train_state(model, 42, 1e-3)
    (params, mstate, _), _, _ = CheckpointManager(model_dir).restore(
        (ts.params, ts.model_state, ts.opt_state))
    predict = make_predict_step(model)

    endpoints, stop = start_servers(sv, 0)
    report(f"serving on {endpoints}")
    try:
        port = endpoints["REST"]
        sock = SocketClient(endpoints["socket"])
        worst = 0.0
        for i, n in enumerate((200, 1000, 200)):
            feats = criteo.synthetic_criteo(n, cfg, start_row=5_000_000 + i)
            feats.pop("label")
            want = np.asarray(predict(params, mstate, feats))
            got = {"rest": C.rest_predict(port, feats),
                   "socket": sock.predict(feats)}
            if "gRPC" in endpoints:
                got["grpc"] = C.grpc_predict(endpoints["gRPC"], feats)
            for proto, p in got.items():
                if p.shape != want.shape or not np.all(np.isfinite(p)):
                    raise AssertionError(f"{proto}: bad output {p.shape}")
                worst = max(worst, float(np.max(np.abs(p - want))))
        sock.close()
    finally:
        stop()
    # the same f32 graph on the same card on identically rounded inputs: the
    # padded bucket only changes the accumulation order of f32 sums
    check(f"served vs in-process predict ({', '.join(got)})", worst, 1e-4,
          "f32 probabilities, same device")


def single_card() -> None:
    import bench

    report("phase 2: reference checks at batch 16384")
    check_gathers(16384)
    check_small_fields(16384)
    check_cin(16384)
    check_deepfm(16384)
    report("phase 3: training through the CLIs")
    train_models()
    report("phase 4: serving")
    serve()
    report("phase 5: steady rate")
    r = bench.measure(16384, 200)
    report(f"bench deepfm batch 16384: {r['examples_per_s']:.1f} examples/s "
           f"over {r['steps']} steps ({r['seconds']:.3f} s; compile "
           f"{r['compile_seconds']:.1f} s)")


# ---------------------------------------------------------------------------
# --four: the SPMD path on four cards
# ---------------------------------------------------------------------------

def four_cards() -> None:
    import jax
    import jax.numpy as jnp

    from recsys.core.config import CriteoConfig, MeshConfig, ModelConfig
    from recsys.core.mesh import make_mesh
    from recsys.data import criteo
    from recsys.models.api import make_model
    from recsys.parallel import spmd
    from recsys.tools import train_ctr
    from recsys.train import optim
    from recsys.train import train_state as TS

    cfg = CriteoConfig()
    bsz, steps, lr = 4096, 3, 1e-3
    batches = [{k: jnp.asarray(v) for k, v in criteo.synthetic_criteo(
        bsz, cfg, start_row=i * bsz).items()} for i in range(steps)]
    for engine in ("split", "fused"):
        # no dropout or batch norm: their per-shard statistics differ from
        # the single-card step by design
        model = make_model("deepfm", cfg, ModelConfig(
            emb_engine=engine, dropout=0.0, use_bn=False))
        opt = optim.adam(lr)
        ts, _ = TS.create_train_state(model, 0, lr, opt=opt)
        local = TS.make_train_step(model, opt)
        ref_losses = []
        for b in batches:
            ts, loss = local(ts, b)
            ref_losses.append(float(loss))
        ref = jax.device_get(ts.params)
        for data, mdl in ((1, 4), (2, 2)):
            env = make_mesh(MeshConfig(data_axis=data, model_axis=mdl),
                            jax.devices()[:4])
            state = spmd.create_spmd_state(model, env, seed=0, opt=opt)
            step = spmd.make_spmd_train_step(model, opt, env, bsz,
                                             batches[0], a2a_exact=True)
            losses = []
            for b in batches:
                state, loss = step(state, spmd.place(
                    b, spmd.batch_specs(b), env))
                losses.append(float(loss))
            got = jax.device_get(state.params)
            tag = f"spmd {engine} mesh {data}x{mdl} vs one card"
            check(f"{tag}: loss over {steps} steps (rel)",
                  max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         ref_losses)),
                  1e-3, "TF32 dots; f32 psum in another order")
            # Adam moves a parameter by at most ~lr per step, so rows whose
            # gradients nearly cancel may differ by up to 2·steps·lr
            diffs = [np.abs(np.asarray(a) - np.asarray(b)) for a, b in
                     zip(jax.tree.leaves(got), jax.tree.leaves(ref))]
            check(f"{tag}: params max |diff|",
                  max(float(d.max()) for d in diffs), 2 * steps * lr,
                  "Adam sign-like early steps")
            check(f"{tag}: params mean |diff|",
                  float(np.mean(np.concatenate([d.ravel() for d in diffs]))),
                  0.01 * lr, "Adam sign-like early steps")
    m = train_ctr.main([
        "train", "--mesh.model_axis=2", "--model.name=deepfm",
        "--train.batch_size=4096", "--train.num_steps=300",
        "--train.eval_every_steps=300", "--train.eval_steps=20",
        "--train.learning_rate=0.003",
        f"--train.model_dir={os.path.join(WORK, 'model_spmd')}"])
    report(f"train deepfm mesh 2x2 streaming 300 steps: eval auc "
           f"{m['auc']:.4f} (need >= 0.78)")
    if not m["auc"] >= 0.78:
        raise AssertionError(f"spmd deepfm eval auc {m['auc']} < 0.78")


def main(argv: list[str] | None = None) -> None:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the SPMD path on four GPUs")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1

    dev = require_gpu(count)
    from recsys.core.compile_cache import enable_compile_cache

    import jax

    CARD = card_name_and_power_limit()
    print(f"jax {jax.__version__}; device_kind {dev.device_kind}; "
          f"{len(jax.devices())} visible, using {count}")
    print(f"card (nvidia-smi name, power.limit): {CARD}")
    print(f"compile cache: {enable_compile_cache()}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    os.chdir(WORK)     # the CLIs write their synthetic shards to ./
    t0 = time.perf_counter()
    if args.four:
        four_cards()
    else:
        single_card()
    report(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(last_line(dev, count))


if __name__ == "__main__":
    main()
