"""End-to-end: tiny synthetic Criteo training must beat an AUC floor
(SURVEY §4d) and checkpoints must round-trip."""

import logging

import jax
import numpy as np

from recsys.core.checkpoint import CheckpointManager
from recsys.core.config import CriteoConfig, ModelConfig, TrainConfig
from recsys.data import criteo
from recsys.models.api import make_model
from recsys.train import loop, train_state as TS

SMALL = CriteoConfig(cat_vocabs=tuple([100] * 26))


def _batches(n_batches, batch_size, start=0):
    data = criteo.synthetic_criteo(
        n_batches * batch_size, SMALL, start_row=start
    )
    for i in range(n_batches):
        lo = i * batch_size
        yield {k: v[lo:lo + batch_size] for k, v in data.items()}


def test_fm_learns_synthetic(tmp_path):
    model = make_model("fm", SMALL, ModelConfig(embedding_dim=8))
    cfg = TrainConfig(
        batch_size=256, learning_rate=0.01, model_dir=str(tmp_path / "m"),
        eval_every_steps=1000, log_every_steps=50, save_checkpoints_steps=1000,
        eval_steps=8,
    )
    train_iter = iter(list(_batches(120, 256)))
    metrics = loop.train_and_evaluate(
        model, train_iter, lambda: _batches(8, 256, start=200_000),
        cfg, num_steps=120,
    )
    assert metrics["auc"] > 0.60, metrics


def test_deepfm_learns_and_resumes(tmp_path, caplog):
    caplog.set_level(logging.INFO, logger="recsys")
    model = make_model(
        "deepfm", SMALL, ModelConfig(embedding_dim=8, deep_layers=(32, 16))
    )
    cfg = TrainConfig(
        # lr 0.01: the planted task gained a second-order term (criteo.py
        # SyntheticSpec) — at 60 tiny steps the first-order structure needs
        # the faster rate to clear the floor
        batch_size=256, learning_rate=0.01, model_dir=str(tmp_path / "m"),
        eval_every_steps=60, log_every_steps=30, save_checkpoints_steps=60,
        eval_steps=6,
    )
    batches = list(_batches(60, 256))
    m1 = loop.train_and_evaluate(
        model, iter(batches), lambda: _batches(6, 256, start=300_000),
        cfg, num_steps=60,
    )
    assert m1["auc"] > 0.58, m1
    # resume continues from step 60 and does zero extra steps
    m2 = loop.train_and_evaluate(
        model, iter([]), lambda: _batches(6, 256, start=300_000),
        cfg, num_steps=60,
    )
    assert "final_loss" in m2


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_max=2)
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.float32(1.5), np.ones((4,), np.int32)]}
    for s, metric in [(1, 0.5), (2, 0.9), (3, 0.7)]:
        mgr.save(s, tree, metric=metric)
    assert mgr.latest_step() == 3
    restored, step, _ = mgr.restore(tree)
    assert step == 3
    np.testing.assert_array_equal(restored["a"], tree["a"])
    # retention: only last 2 kept
    assert mgr.restore(tree, step=1) is None  # pruned
    import os
    assert not os.path.exists(str(tmp_path) + "/step_1")
    # best points at metric 0.9 (step 2)
    best, bstep, _ = mgr.restore(tree, best=True)
    assert bstep == 2


def test_eval_step_streaming(tmp_path):
    model = make_model("wide", SMALL, ModelConfig())
    params, state = model.init(jax.random.key(0))
    metrics = loop.evaluate(model, params, state, _batches(4, 128))
    assert metrics["count"] == 512
    assert 0.0 <= metrics["auc"] <= 1.0


def test_wide_trains_with_ftrl(tmp_path):
    """The wide model is FTRL-backed like the reference's LinearClassifier
    (deep&wide/deep&wide.py:146-149; FTRL math ftrl/ftrl.py:153-181)."""
    from recsys.train import optim

    model = make_model("wide", SMALL, ModelConfig())
    assert model.meta.get("optimizer") == "ftrl"
    ts, tx = TS.create_train_state(model, seed=0, learning_rate=0.5)
    assert isinstance(ts.opt_state, optim.FtrlState)
    step = TS.make_train_step(model, tx)
    losses = []
    for batch in _batches(80, 256):
        ts, loss = step(ts, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_checkpoint_restore_is_strict(tmp_path):
    """Shape or dtype mismatches must fail loud, not silently cast/reshape."""
    import pytest

    mgr = CheckpointManager(str(tmp_path), keep_max=2)
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    mgr.save(1, tree)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": np.zeros((3, 2), np.float32)})
    with pytest.raises(ValueError, match="dtype"):
        mgr.restore({"a": np.zeros((2, 3), np.int32)})
    restored, _, _ = mgr.restore({"a": np.zeros((2, 3), np.float32)})
    np.testing.assert_array_equal(restored["a"], tree["a"])


def test_scalar_summaries_roundtrip(tmp_path):
    from recsys.train.summaries import ScalarWriter, read_scalars

    with ScalarWriter(str(tmp_path)) as w:
        w.write(10, loss=1.5, examples_per_sec=1000.0)
        w.write(20, loss=1.2, eval_auc=0.7)
    recs = read_scalars(str(tmp_path))
    assert [r["step"] for r in recs] == [10, 20]
    assert recs[1]["eval_auc"] == 0.7


def test_deepfm_demo_schema_learns(tmp_path):
    """The reference DeepFM's hashed-int u_id/i_id demo variant
    (deepfm/deepfm.py:41-49): the generic CTR zoo runs on a 2-field schema
    and learns the planted user×item structure."""
    from recsys.data import demo

    schema = demo.demo_schema(u_buckets=20_000, i_buckets=5_000)
    data = demo.synthetic_demo(40_000, n_users=300, n_items=100, rank=4,
                               seed=7, schema=schema)
    assert data["ids"].shape == (40_000, 2)
    assert data["dense"].shape == (40_000, 0)

    model = make_model("deepfm", schema,
                       ModelConfig(embedding_dim=8, deep_layers=(32, 16),
                                   dropout=0.1))
    cfg = TrainConfig(batch_size=256, learning_rate=0.02,
                      model_dir=str(tmp_path / "demo"),
                      eval_every_steps=10_000, log_every_steps=200,
                      save_checkpoints_steps=10_000, eval_steps=8)

    # pure id-x-id interaction needs several epochs over the 30k train rows
    def train_batches():
        for s in range(600):
            lo = (s * 256) % 30_000
            yield {k: v[lo:lo + 256] for k, v in data.items()}

    def eval_batches():
        for b in range(8):
            lo = 32_000 + b * 256
            yield {k: v[lo:lo + 256] for k, v in data.items()}

    metrics = loop.train_and_evaluate(
        model, train_batches(), eval_batches, cfg, num_steps=600)
    assert metrics["auc"] > 0.60, metrics


def test_checkpoint_crash_atomic_resume(tmp_path):
    """A partial (crashed mid-write) step dir must be invisible to
    latest_step/restore; a leftover .tmp from a crash is ignored."""
    import os
    import numpy as np

    mgr = CheckpointManager(str(tmp_path), keep_max=3)
    tree = {"w": np.arange(4, dtype=np.float32)}
    mgr.save(1, tree)
    # simulate a crash mid-write of step 2: only the .tmp dir exists
    os.makedirs(tmp_path / "step_2.tmp")
    with open(tmp_path / "step_2.tmp" / "meta.json", "w") as f:
        f.write("{")                       # truncated garbage
    assert mgr.latest_step() == 1
    restored = mgr.restore({"w": np.zeros(4, np.float32)})
    assert restored is not None
    got, step, _ = restored
    assert step == 1
    np.testing.assert_array_equal(got["w"], tree["w"])
    # next save of the same step recovers: tmp is replaced, publish works
    mgr.save(2, {"w": np.ones(4, np.float32)})
    assert mgr.latest_step() == 2
