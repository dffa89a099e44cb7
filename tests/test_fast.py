"""Fast path: scan-fused steps match semantics of per-step training."""

import jax.numpy as jnp
import numpy as np

from recsys.core.config import CriteoConfig, ModelConfig, TrainConfig
from recsys.data import criteo
from recsys.models.api import make_model
from recsys.train import fast, loop
from recsys.train import train_state as TS

SMALL = CriteoConfig(cat_vocabs=tuple([80] * 26))


def test_scanned_steps_learn():
    model = make_model("fm", SMALL, ModelConfig(embedding_dim=8))
    ts, tx = TS.create_train_state(model, seed=0, learning_rate=0.01)
    data = criteo.synthetic_criteo(20_000, SMALL)
    staged = fast.stage_dataset(data)
    step_fn = fast.make_scanned_train_step(model, tx)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(6):
        idx = fast.epoch_index_matrix(20_000, 256, 20, rng)
        ts, loss = step_fn(ts, staged, jnp.asarray(idx))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert int(ts.step) == 120


def test_scanned_eval_matches_streaming():
    model = make_model("fm", SMALL, ModelConfig(embedding_dim=8))
    ts, _ = TS.create_train_state(model, seed=0, learning_rate=0.01)
    data = criteo.synthetic_criteo(2048, SMALL)
    staged = fast.stage_dataset(data)
    eval_fn = fast.make_scanned_eval(model)
    from recsys.train import metrics as M
    idx = np.arange(2048).reshape(8, 256)
    m1 = M.finalize_binary_metrics(eval_fn(
        ts.params, ts.model_state, staged, jnp.asarray(idx, jnp.int32),
        M.init_binary_metrics()))

    def batches():
        for i in range(8):
            yield {k: v[i * 256:(i + 1) * 256] for k, v in data.items()}

    m2 = loop.evaluate(model, ts.params, ts.model_state, batches())
    assert abs(m1["auc"] - m2["auc"]) < 1e-6
    assert abs(m1["logloss"] - m2["logloss"]) < 1e-5
    assert m1["count"] == m2["count"] == 2048


def test_fast_driver_end_to_end(tmp_path):
    model = make_model("deepfm", SMALL,
                       ModelConfig(embedding_dim=8, deep_layers=(16, 8)))
    cfg = TrainConfig(batch_size=256, learning_rate=0.005,
                      model_dir=str(tmp_path / "m"),
                      eval_every_steps=100, eval_steps=8)
    train_data = criteo.synthetic_criteo(30_000, SMALL)
    eval_data = criteo.synthetic_criteo(4_096, SMALL, start_row=500_000)
    metrics = loop.train_and_evaluate_fast(
        model, train_data, eval_data, cfg, num_steps=200)
    assert metrics["auc"] > 0.58, metrics
    # resume path
    m2 = loop.train_and_evaluate_fast(
        model, train_data, eval_data, cfg, num_steps=200)
    assert "final_loss" in m2
