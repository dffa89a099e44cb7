"""Multi-process smoke worker — validates the §5.8 multi-host bring-up
that single-process tests cannot: ``jax.distributed.initialize`` across OS
processes, per-host input sharding (``host_shard_of``), and a cross-process
collective (psum over a global mesh).

On a real pod slice each host runs the same sequence (SURVEY §5.8,
core/mesh.py:distributed_init); here the "hosts" are local CPU processes,
each exposing ``--local_devices`` virtual CPU devices, so the global mesh
spans processes exactly like hosts on DCN.

Run one worker per process:
    python -m recsys.tools.mp_smoke --coordinator=127.0.0.1:PORT \
        --num_processes=2 --process_id=K [--local_devices=2]

Prints one JSON line: {"ok": true, process/device counts, the psum result,
and this worker's file shard} — asserted by tests/test_multiprocess.py.

``--mode=stream`` runs the full streaming SPMD training path instead
(reference analog: MirroredStrategy train_and_evaluate over per-process
TFRecord lists, deepfm/deepfm.py:159-210): each process reads ITS
host-shard of the synthetic npz shards through `ShardSource` →
`device_prefetch` (process-local slices assembled into global arrays) →
`train_and_evaluate_spmd_stream` over the global mesh, then reports final
eval AUC. Extra flags: --data_dir --eval_dir --model_dir [--num_steps].
"""

from __future__ import annotations

import json
import os
import sys


def main(argv: list[str] | None = None) -> dict:
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a[2:].split("=", 1) for a in argv
              if a.startswith("--") and "=" in a)
    n_local = int(kv.get("local_devices", 2))
    num_processes = int(kv["num_processes"])
    process_id = int(kv["process_id"])

    # Force the CPU platform BEFORE first jax use: the processes of this
    # smoke share one host, and two JAX processes cannot both hold one GPU.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_local}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    from recsys.core import mesh as mesh_lib

    mesh_lib.distributed_init(
        coordinator_address=kv["coordinator"],
        num_processes=num_processes,
        process_id=process_id,
    )
    assert jax.process_count() == num_processes
    assert jax.process_index() == process_id
    n_global = jax.device_count()
    assert n_global == num_processes * n_local

    if kv.get("mode") == "stream":
        return _stream_main(kv, jax, mesh_lib, n_global, process_id)

    # per-host input sharding: shards must be disjoint and covering
    files = [f"part-{i:02d}" for i in range(7)]
    my_files = mesh_lib.host_shard_of(files)

    # cross-process collective: each process contributes its local batch
    # rows to a global array over the ('data','model') mesh; a jitted global
    # sum must see every process's rows (DCN-riding psum on a real slice).
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    env = mesh_lib.make_mesh(
        mesh_lib.MeshConfig(data_axis=n_global, model_axis=1))
    local_rows = np.full((n_local, 4), float(process_id + 1), np.float32)
    global_arr = jax.make_array_from_process_local_data(
        NamedSharding(env.mesh, P("data", None)), local_rows,
        (n_global, 4),
    )
    total = jax.jit(lambda x: x.sum(),
                    out_shardings=NamedSharding(env.mesh, P()))(global_arr)
    # expected: sum over procs of (n_local rows × 4 cols × (pid+1))
    expect = sum(n_local * 4 * (p + 1) for p in range(num_processes))
    got = float(jax.device_get(total))

    result = {
        "ok": abs(got - expect) < 1e-5,
        "process_id": process_id,
        "process_count": jax.process_count(),
        "global_devices": n_global,
        "psum": got,
        "expected": expect,
        "file_shard": my_files,
    }
    print(json.dumps(result))
    return result



def _stream_main(kv, jax, mesh_lib, n_global: int, process_id: int) -> dict:
    """Streaming SPMD e2e under jax.distributed: file-sharded ShardSource →
    device_prefetch (process-local → global arrays) → spmd stream driver →
    final eval AUC above floor."""
    import glob

    from recsys.core.config import CriteoConfig, ModelConfig, TrainConfig
    from recsys.data import loader
    from recsys.models.api import make_model
    from recsys.train import spmd_loop

    small = CriteoConfig(cat_vocabs=tuple([200] * 6))
    env = mesh_lib.make_mesh(
        mesh_lib.MeshConfig(data_axis=n_global, model_axis=1))

    paths = sorted(glob.glob(os.path.join(kv["data_dir"], "*.npz")))
    eval_paths = sorted(glob.glob(os.path.join(kv["eval_dir"], "*.npz")))
    my_paths = mesh_lib.host_shard_of(paths)
    my_eval = mesh_lib.host_shard_of(eval_paths)

    cfg = TrainConfig(
        batch_size=128, learning_rate=0.005,
        model_dir=os.path.join(kv["model_dir"], f"p{process_id}"),
        eval_every_steps=10_000, eval_steps=8,
    )
    src = loader.ShardSource(my_paths, cfg.batch_size, seed=process_id,
                             num_epochs=-1)

    def eval_batches():
        return loader.ShardSource(my_eval, cfg.batch_size, shuffle=False,
                                  num_epochs=1)

    model = make_model("deepfm", small,
                       ModelConfig(embedding_dim=8, deep_layers=(16, 8)))
    metrics = spmd_loop.train_and_evaluate_spmd_stream(
        model, iter(src), eval_batches, cfg, env=env,
        num_steps=int(kv.get("num_steps", 200)),
    )
    result = {
        "ok": bool(metrics["auc"] > 0.58),
        "mode": "stream",
        "process_id": process_id,
        "global_devices": n_global,
        "auc": metrics["auc"],
        "logloss": metrics["logloss"],
        "steps_done": metrics["steps_done"],
        "file_shard": [os.path.basename(p) for p in my_paths],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
