"""Profile one fused training call of a CTR model and print where device
time goes (top HLO fusions attributed to framework source lines).

    python -m recsys.tools.profile_step --model.name=deepfm \
        --train.batch_size=8192 [--steps_per_call=20]
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from recsys.core.config import RunConfig, apply_overrides
from recsys.data import criteo
from recsys.models.api import make_model
from recsys.train import fast
from recsys.train import train_state as TS
from recsys.utils import profiling


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    k = 20
    overrides = []
    for a in argv:
        if a.startswith("--steps_per_call="):
            k = int(a.split("=")[1])
        else:
            overrides.append(a)
    cfg = apply_overrides(RunConfig(), overrides)

    model = make_model(cfg.model.name, cfg.criteo, cfg.model)
    ts, tx = TS.create_train_state(model, cfg.train.seed,
                                   cfg.train.learning_rate)
    n = max(4 * cfg.train.batch_size, 65536)
    data = criteo.synthetic_criteo(n, cfg.criteo)
    staged = fast.stage_dataset(data)
    step_fn = fast.make_scanned_train_step(model, tx)
    rng = np.random.default_rng(0)
    idx = jnp.asarray(fast.epoch_index_matrix(n, cfg.train.batch_size, k, rng))

    # warm/compile, keep the lowering for HLO annotation
    compiled = step_fn.lower(ts, staged, idx).compile()
    ts, loss = step_fn(ts, staged, idx)
    float(loss)

    trace_dir = profiling.trace_step(lambda: step_fn(ts, staged, idx)[1])
    rows = profiling.device_breakdown(trace_dir)
    rows = profiling.annotate_with_hlo(rows, compiled.as_text())
    total = sum(r["total_ms"] for r in rows)
    print(f"\n=== {cfg.model.name} batch={cfg.train.batch_size} "
          f"({k} steps/call) — top device ops ===")
    profiling.print_breakdown(rows)
    print(f"(top-{len(rows)} total {total:.1f} ms per {k}-step call → "
          f"~{total/k:.2f} ms/step attributed)")


if __name__ == "__main__":
    main()
