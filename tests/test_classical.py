"""FTRL-proximal and GBDT+LR pipelines (SURVEY §2.1 rows 8, 13)."""

import numpy as np

from recsys.models import ftrl_lr as F
from recsys.models import gbdt_lr as G


def _avazu_like_csv(path, n=600, seed=0):
    rng = np.random.default_rng(seed)
    cols = ["id", "click", "hour", "site", "app", "device"]
    # planted: click depends on site/app identity
    site_eff = rng.normal(0, 1.2, 20)
    app_eff = rng.normal(0, 1.2, 15)
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(n):
            site = rng.integers(0, 20)
            app = rng.integers(0, 15)
            day = rng.integers(1, 12)
            logit = -0.5 + site_eff[site] + app_eff[app]
            y = int(rng.random() < 1 / (1 + np.exp(-logit)))
            f.write(
                f"{i},{y},1410{day:02d}{rng.integers(0,24):02d},"
                f"s{site},a{app},d{rng.integers(0,5)}\n"
            )


def test_ftrl_learns_and_validates(tmp_path):
    path = str(tmp_path / "train.csv")
    _avazu_like_csv(path, n=800)
    learner, val_loss = F.train_csv(path, epochs=2, holdafter=8, D=2 ** 16,
                                    alpha=0.3)
    assert np.isfinite(val_loss)
    # the planted structure must beat base-rate logloss
    import csv
    ys, ps = [], []
    with open(path) as f:
        for row in csv.DictReader(f):
            x, y, date = F.hash_csv_row(row, 2 ** 16)
            if date > 8:
                ys.append(y)
                ps.append(learner.predict(np.asarray(x)))
    base = np.mean(ys)
    base_ll = -np.mean([np.log(base) if y else np.log(1 - base) for y in ys])
    assert val_loss < base_ll


def test_ftrl_poly2_interactions(tmp_path):
    path = str(tmp_path / "train.csv")
    _avazu_like_csv(path, n=200)
    learner, val_loss = F.train_csv(path, holdafter=8, D=2 ** 14,
                                    interaction=True)
    assert np.isfinite(val_loss)


def test_ftrl_submission(tmp_path):
    train = str(tmp_path / "train.csv")
    sub = str(tmp_path / "submission.csv")
    _avazu_like_csv(train, n=150)
    learner, _ = F.train_csv(train, holdafter=None, D=2 ** 14)
    F.write_submission(learner, train, sub)
    lines = open(sub).read().strip().split("\n")
    assert lines[0] == "id,click"
    assert len(lines) == 151
    p = float(lines[1].split(",")[1])
    assert 0.0 <= p <= 1.0


def _forest_like(n=800, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 10))
    logit = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = (logit + rng.normal(0, 0.8, n) > 0).astype(np.int64)
    return x.astype(np.float32), y


def test_gbdt_lr_pipeline():
    x, y = _forest_like()
    out = G.gbdt_lr_pipeline(x[:600], y[:600], x[600:], y[600:],
                             n_trees=20, num_leaves=8)
    assert out["nce"] < 1.0   # beats base-rate entropy
    leaves = G.leaf_indices(out["gbdt"], x[:5])
    assert leaves.shape == (5, 20)
    oh = G.leaf_one_hot(leaves, out["leaf_width"])
    assert (oh.sum(axis=1) == 20).all()   # one hot per tree
    merged = G.merged_features(x[:5], leaves)
    assert merged.shape == (5, 30)


def _forest_multiclass(n=900, n_classes=3, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    w = rng.normal(size=(8, n_classes))
    y = np.argmax(x @ w + rng.gumbel(0, 0.3, (n, n_classes)), axis=1)
    return x, y.astype(np.int64)


def test_leaf_feature_comparison():
    """main.py:20-118 experiment: both second-stage models beat chance and
    the report carries the raw-vs-merged comparison."""
    x, y = _forest_multiclass()
    out = G.leaf_feature_comparison(x, y, stage1_trees=5, stage2_trees=15,
                                    num_leaves=8)
    chance = 1.0 / len(np.unique(y))
    assert out["acc_raw"] > chance + 0.1
    assert out["acc_raw_plus_leaf"] > chance + 0.1
    assert out["n_leaf_features"] == 5 * 3   # trees × classes flattened
    assert "leaf_gain" in out


def test_gbdt_fe_cli(capsys):
    from recsys.tools.gbdt_fe import main
    out = main(["--synthetic_rows=600", "--n_trees=10", "--num_leaves=8",
                "--stage1_trees=4", "--stage2_trees=8"])
    assert out["gbdt_lr"]["nce"] < 1.0
    assert 0 <= out["comparison"]["acc_raw"] <= 1
