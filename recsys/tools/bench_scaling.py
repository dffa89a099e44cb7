"""Multi-device scaling bench on the virtual CPU mesh.

The reference's only scaling evidence is "same global_step/sec with 1 vs 2
GPUs, 2× examples/step" (deepfm/readme.md:46-71). This tool produces the
analogous measurement for the SPMD path: weak scaling (fixed per-device
batch) of the scanned SPMD train step over ('data','model') meshes of
1..N virtual CPU devices, plus the all-to-all collective sizes implied by
the sharded-embedding capacity formula.

Caveat printed with the results: on a virtual CPU mesh all "devices" share
the host's cores, so absolute ex/s is meaningless and parallel efficiency
is a LOWER bound dominated by host-core contention — what the table does
establish is that the compiled SPMD program (collectives included) exists,
runs, and how its per-step overhead grows with mesh size. Real scaling
must be measured on real devices.

Usage:
    python -m recsys.tools.bench_scaling \
        [--devices=1,2,4,8] [--model_axis=2] [--batch_per_device=1024] \
        [--steps=30] [--model=deepfm]

Each mesh size runs in its own subprocess (the virtual device count is
fixed per process by XLA_FLAGS).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def _worker(kv: dict) -> None:
    n = int(kv["worker"])
    inherited = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if not f.startswith("--xla_force_host_platform_device_count")]
    os.environ["XLA_FLAGS"] = " ".join(
        [f"--xla_force_host_platform_device_count={n}"] + inherited)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import time

    import numpy as np

    from recsys.core.config import CriteoConfig, MeshConfig, ModelConfig
    from recsys.core.mesh import make_mesh
    from recsys.data import criteo
    from recsys.models.api import make_model
    from recsys.parallel import spmd
    from recsys.train import optim

    model_axis = min(int(kv.get("model_axis", 2)), n)
    bs = int(kv.get("batch_per_device", 1024)) * n
    steps = int(kv.get("steps", 30))
    name = kv.get("model", "deepfm")

    criteo_cfg = CriteoConfig()
    model = make_model(name, criteo_cfg, ModelConfig(name=name))
    env = make_mesh(MeshConfig(data_axis=n // model_axis,
                               model_axis=model_axis))
    opt = optim.for_model(model.meta, 1e-3)
    params, mstate = model.init(jax.random.key(0))
    opt_state = opt.init(params)
    pspecs = spmd.param_specs(params)
    state = spmd.SpmdState(
        params=spmd.place(params, pspecs, env),
        model_state=spmd.place(
            mstate, jax.tree.map(lambda _: spmd.P(), mstate), env),
        opt_state=spmd.place(opt_state, spmd.opt_specs(pspecs, opt_state),
                             env),
        step=jax.numpy.asarray(0, jax.numpy.int32),
        rng=jax.random.key(1),
    )

    data = criteo.synthetic_criteo(max(4 * bs, 16384), criteo_cfg)
    rng = np.random.default_rng(0)
    k = min(10, steps)
    idx = rng.integers(0, len(data["label"]), size=(k, bs))
    stack = {key: v[idx] for key, v in data.items()}
    step_fn = spmd.make_spmd_train_step_scanned(model, opt, env, stack)

    state, loss = step_fn(state, stack)           # compile + warm
    float(np.asarray(loss))
    calls = max(1, steps // k)
    t0 = time.perf_counter()
    for _ in range(calls):
        state, loss = step_fn(state, stack)
    final = float(np.asarray(loss))
    dt = time.perf_counter() - t0
    out = {
        "devices": n, "model_axis": model_axis, "batch": bs,
        "step_ms": dt / (calls * k) * 1e3,
        "examples_per_s": calls * k * bs / dt,
        "loss": final,
    }
    print("WORKER_RESULT " + json.dumps(out))


_COLLECTIVE_RE = None


def measured_collectives(model_axis: int, data_axis: int, batch: int,
                         model_name: str = "deepfm",
                         cap_factor: float = 2.0) -> dict:
    """MEASURED per-step collective volumes: compile the scanned SPMD train
    step on a virtual mesh and parse every collective instruction (shape →
    bytes) out of the optimized HLO. This is the ground truth the
    documented capacity contract (parallel/sharded_embedding.py module
    docstring) is asserted against in tests/test_bench_scaling.py — if the
    lookup ever regresses into moving dense [B,F,W] activations through the
    exchange, these numbers jump and the test fails.

    Returns {'all-to-all': [...], 'all-gather': [...], 'all-reduce': [...],
    'reduce-scatter': [...], 'collective-permute': [...]} where each entry
    is (dtype, shape, bytes) of one instruction in the step program
    (backward included — scan bodies appear once).
    """
    import re

    import jax
    import jax.numpy as jnp
    import numpy as np

    from recsys.core.config import CriteoConfig, MeshConfig, ModelConfig
    from recsys.core.mesh import make_mesh
    from recsys.data import criteo
    from recsys.models.api import make_model
    from recsys.parallel import spmd
    from recsys.train import optim

    cfg = CriteoConfig()
    model = make_model(model_name, cfg, ModelConfig(name=model_name))
    env = make_mesh(MeshConfig(data_axis=data_axis, model_axis=model_axis,
                               a2a_cap_factor=cap_factor))
    opt = optim.for_model(model.meta, 1e-3)
    params, mstate = model.init(jax.random.key(0))
    opt_state = opt.init(params)
    pspecs = spmd.param_specs(params)
    state = spmd.SpmdState(
        params=spmd.place(params, pspecs, env),
        model_state=spmd.place(
            mstate, jax.tree.map(lambda _: spmd.P(), mstate), env),
        opt_state=spmd.place(opt_state, spmd.opt_specs(pspecs, opt_state),
                             env),
        step=jnp.asarray(0, jnp.int32),
        rng=jax.random.key(1),
    )
    data = criteo.synthetic_criteo(batch, cfg)
    stack = {k: v[None] for k, v in data.items()}   # [K=1, B, ...]
    step_fn = spmd.make_spmd_train_step_scanned(
        model, opt, env, stack, a2a_cap_factor=cap_factor)
    placed = spmd.place(stack, jax.tree.map(
        lambda v: spmd.P(None, "data", *([None] * (v.ndim - 2))), stack), env)
    hlo = step_fn.lower(state, placed).compile().as_text()

    dt_bytes = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2,
                "pred": 1, "s8": 1, "u8": 1, "f64": 8, "s64": 8, "u64": 8}
    out: dict[str, list] = {}
    pat = re.compile(
        r"=\s+(\w+)\[([0-9,]*)\][^=]*?\b"
        r"(all-to-all|all-gather|all-reduce|reduce-scatter|"
        r"collective-permute)\b")
    for m in pat.finditer(hlo):
        dt, shape_s, kind = m.groups()
        shape = tuple(int(x) for x in shape_s.split(",")) if shape_s else ()
        nbytes = dt_bytes.get(dt, 4) * int(np.prod(shape, dtype=np.int64))
        out.setdefault(kind, []).append(
            {"dtype": dt, "shape": shape, "bytes": nbytes})
    return out


def collective_sizes(batch: int, model_axis: int,
                     width: int, cap_factor: float = 2.0) -> dict:
    """Bytes moved per step by the sharded-embedding all-to-alls
    (parallel/sharded_embedding.a2a_capacity), per (src,dst) pair."""
    from recsys.core.config import CriteoConfig
    from recsys.embeddings.engines import SPLIT_THRESHOLD
    from recsys.parallel.sharded_embedding import a2a_capacity

    cfg = CriteoConfig()
    big_fields = sum(1 for v in cfg.field_vocab_sizes if v > SPLIT_THRESHOLD)
    n_flat = batch * big_fields
    cap = a2a_capacity(n_flat, model_axis, cap_factor, exact=False)
    id_bytes = model_axis * cap * 4
    act_bytes = model_axis * cap * width * 4
    return {
        "big_field_ids_per_step": n_flat,
        "a2a_capacity_ids_per_pair": cap,
        "id_exchange_bytes_per_device": id_bytes,
        "activation_return_bytes_per_device": act_bytes,
        "note": ("comms scale with unique ids (dedup before exchange), "
                 "not with the [B,F,D] activation as a psum design would"),
    }


def main(argv: list[str] | None = None) -> dict:
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a[2:].split("=", 1) for a in argv
              if a.startswith("--") and "=" in a)
    if "worker" in kv:
        _worker(kv)
        return {}

    devices = [int(d) for d in kv.get("devices", "1,2,4,8").split(",")]
    rows = []
    for n in devices:
        cmd = [sys.executable, "-m", "recsys.tools.bench_scaling",
               f"--worker={n}"]
        for key in ("model_axis", "batch_per_device", "steps", "model"):
            if key in kv:
                cmd.append(f"--{key}={kv[key]}")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("WORKER_RESULT ")), None)
        if line is None:
            raise RuntimeError(
                f"worker devices={n} failed:\n{proc.stderr[-2000:]}")
        rows.append(json.loads(line[len("WORKER_RESULT "):]))

    base = rows[0]["examples_per_s"] / rows[0]["devices"]
    for r in rows:
        r["parallel_efficiency"] = (
            r["examples_per_s"] / r["devices"] / base)

    result = {
        "weak_scaling": rows,
        "collectives": collective_sizes(
            batch=int(kv.get("batch_per_device", 1024)) * max(devices),
            model_axis=min(int(kv.get("model_axis", 2)), max(devices)),
            width=17),
        "caveat": "virtual CPU mesh: devices share host cores; efficiency "
                  "is a lower bound, absolute ex/s not meaningful",
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
