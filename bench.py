"""Benchmark: DeepFM Criteo training throughput on one GPU.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "examples/s", "device": {...}}

Config: full Criteo feature space (39 fields, 100k-capped hashed vocabs),
embedding dim 16, DNN 100,100 with BN+dropout, Adam — the reference's README
experiment setup (README.md:32-36) — at global batch 16384 instead of the
reference's 256 (per-epoch example count, not step count, is the work unit).

Exits non-zero unless JAX's default backend is a GPU: a CPU number is not a
device measurement.

    python bench.py [batch_size] [steps]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def require_gpu():
    """The first device, or SystemExit unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default device is "
                         f"{dev.platform} ({dev.device_kind})")
    return dev


def measure(batch_size: int = 16384, steps: int = 200) -> dict:
    """Steady-state DeepFM training examples/s on the default device:
    device-resident dataset, batch indices drawn on device, 50 steps fused
    per dispatch (the path `loop.train_and_evaluate_fast` drives)."""
    from recsys.core.config import CriteoConfig, ModelConfig
    from recsys.data import criteo
    from recsys.models.api import make_model
    from recsys.train import fast
    from recsys.train import train_state as TS

    criteo_cfg = CriteoConfig()
    model = make_model(
        "deepfm", criteo_cfg,
        ModelConfig(embedding_dim=16, deep_layers=(100, 100)),
    )
    ts, tx = TS.create_train_state(model, seed=0, learning_rate=1e-3)

    data = criteo.synthetic_criteo(max(4 * batch_size, 65536), criteo_cfg)
    staged = fast.stage_dataset(data)
    n = len(data["label"])
    k = 50
    step_fn = fast.make_scanned_train_step_devgen(model, tx, n, batch_size)

    t0 = time.perf_counter()
    ts, loss = step_fn(ts, staged, k)          # compile + first call
    float(loss)
    compile_s = time.perf_counter() - t0

    calls = max(1, -(-steps // k))   # ceil: honor the requested step count
    t0 = time.perf_counter()
    for _ in range(calls):
        ts, loss = step_fn(ts, staged, k)
    final_loss = float(loss)    # waits for the chain of donated states
    dt = time.perf_counter() - t0
    if not np.isfinite(final_loss):
        raise FloatingPointError(f"non-finite loss {final_loss}")
    return {"examples_per_s": batch_size * k * calls / dt,
            "batch_size": batch_size, "steps": k * calls,
            "seconds": dt, "compile_seconds": compile_s,
            "final_loss": final_loss}


def main() -> None:
    from recsys.core.compile_cache import enable_compile_cache

    dev = require_gpu()
    enable_compile_cache()
    import jax

    batch_size = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    r = measure(batch_size, steps)
    print(json.dumps({
        "metric": "deepfm_criteo_train_examples_per_sec",
        "value": r["examples_per_s"],
        "unit": "examples/s",
        "batch_size": batch_size,
        "steps": r["steps"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
