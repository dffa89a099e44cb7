"""Multi-process bring-up smoke (SURVEY §5.8): two local OS processes join
via jax.distributed.initialize on CPU, shard input files disjointly, and a
jitted global reduction sees both processes' data."""

import json
import os
import socket
import subprocess
import sys

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_psum_and_file_sharding():
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["JAX_PLATFORMS"] = "cpu"

    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "recsys.tools.mp_smoke",
             f"--coordinator=127.0.0.1:{port}",
             "--num_processes=2", f"--process_id={pid}",
             "--local_devices=2"],
            cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    for rec in outs:
        assert rec["ok"], rec
        assert rec["process_count"] == 2
        assert rec["global_devices"] == 4
        # both processes agree on the global sum: 2*4*1 + 2*4*2 = 24
        assert rec["psum"] == rec["expected"] == 24.0

    # file shards are disjoint and covering
    shard0 = set(outs[0]["file_shard"]) if outs[0]["process_id"] == 0 else set(outs[1]["file_shard"])
    shard1 = set(outs[1]["file_shard"]) if outs[1]["process_id"] == 1 else set(outs[0]["file_shard"])
    assert shard0.isdisjoint(shard1)
    assert shard0 | shard1 == {f"part-{i:02d}" for i in range(7)}
    assert abs(len(shard0) - len(shard1)) <= 1


def test_two_process_streaming_train_to_auc_floor(tmp_path):
    """Full streaming SPMD e2e across two OS processes (VERDICT r4 #7):
    each process streams ITS file shard of the synthetic dataset through
    ShardSource → device_prefetch → train_and_evaluate_spmd_stream over a
    4-device global mesh, and both report final eval AUC above the floor
    (the 2-worker MirroredStrategy train_and_evaluate analog,
    deepfm/deepfm.py:159-210 + :188-194 per-process file lists)."""
    from recsys.core.config import CriteoConfig
    from recsys.data import criteo

    small = CriteoConfig(cat_vocabs=tuple([200] * 6))
    data_dir, eval_dir = str(tmp_path / "train"), str(tmp_path / "eval")
    # 4 train shards (2 per process), 2 eval shards (1 per process; both
    # sides must yield the same batch count or collectives would desync)
    criteo.write_synthetic_shards(data_dir, 32_768, 4, small)
    criteo.write_synthetic_shards(eval_dir, 4_096, 2, small)

    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["JAX_PLATFORMS"] = "cpu"

    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "recsys.tools.mp_smoke",
             "--mode=stream",
             f"--coordinator=127.0.0.1:{port}",
             "--num_processes=2", f"--process_id={pid}",
             "--local_devices=2",
             f"--data_dir={data_dir}", f"--eval_dir={eval_dir}",
             f"--model_dir={tmp_path / 'm'}", "--num_steps=200"],
            cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=360)
        assert p.returncode == 0, f"stream worker failed:\n{out}\n{err}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    shards = []
    for rec in outs:
        assert rec["ok"], rec
        assert rec["steps_done"] >= 200
        assert rec["auc"] > 0.58, rec
        shards.append(set(rec["file_shard"]))
    # both processes agree on the (replicated) eval metrics
    assert abs(outs[0]["auc"] - outs[1]["auc"]) < 1e-6
    # and streamed disjoint file shards
    assert shards[0].isdisjoint(shards[1])
    assert len(shards[0] | shards[1]) == 4
