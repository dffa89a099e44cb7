"""Data plane: TSV preprocessing semantics, loader batching, determinism."""

import numpy as np
import pytest

from recsys.core.config import CriteoConfig
from recsys.data import criteo, hashing, loader


def _write_tsv(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(r) + "\n")


def test_hash_stability_and_range():
    assert hashing.hash_bucket("abc", 1000) == hashing.hash_bucket("abc", 1000)
    vals = [f"v{i}" for i in range(5000)]
    ids = hashing.hash_bucket_array(np.array(vals, dtype=object), 100)
    assert ids.min() >= 0 and ids.max() < 100
    # roughly uniform occupancy
    counts = np.bincount(ids, minlength=100)
    assert counts.min() > 10


def test_preprocess_tsv_semantics(tmp_path):
    cfg = CriteoConfig()
    rows = [
        # label, 13 cont (some missing), 26 cat (some missing)
        ["1"] + ["2"] * 13 + ["aa"] * 26,
        ["0"] + [""] + ["4"] * 12 + [""] + ["bb"] * 25,
    ]
    tsv = tmp_path / "train.tsv"
    _write_tsv(tsv, rows)
    shards = criteo.preprocess_tsv(str(tsv), str(tmp_path / "out"),
                                   cfg, rows_per_shard=10)
    assert len(shards) == 1
    with np.load(shards[0]) as z:
        ids, dense, label = z["ids"], z["dense"], z["label"]
    assert ids.shape == (2, 39) and dense.shape == (2, 13)
    np.testing.assert_array_equal(label, [1, 0])
    # missing cont in row 1 col 0 imputed with the column mean (=2)
    assert abs(dense[1, 0] - np.log(2 + 1)) < 1e-6
    # _c2 (col index 1) uses log(x+4)   (fm/fm.py:77-78)
    assert abs(dense[0, 1] - np.log(2 + 4)) < 1e-6
    # bucket ids within range; cat ids hashed consistently with NULL fill
    for j, bounds in enumerate(cfg.cont_boundaries):
        assert ids[:, j].max() <= len(bounds)
    null_id = hashing.hash_bucket("NULL", cfg.cat_vocabs[0])
    assert ids[1, 13] == null_id
    aa_id = hashing.hash_bucket("aa", cfg.cat_vocabs[0])
    assert ids[0, 13] == aa_id


def test_bucketize_matches_searchsorted():
    cfg = CriteoConfig()
    vals = np.array([[0.0] * 13, [3.0] * 13, [1e6] * 13], np.float32)
    ids = criteo.bucketize_cont(vals, cfg)
    # value 0.0 for field 0 (bounds 0,1,2,3,5,12): searchsorted right → 1
    assert ids[0, 0] == 1
    assert ids[2, 0] == len(cfg.cont_boundaries[0])  # top bucket


def test_synthetic_learnable_structure():
    d1 = criteo.synthetic_criteo(2000)
    d2 = criteo.synthetic_criteo(2000)
    np.testing.assert_array_equal(d1["ids"], d2["ids"])  # deterministic
    rate = d1["label"].mean()
    assert 0.05 < rate < 0.6
    # disjoint slices differ
    d3 = criteo.synthetic_criteo(2000, start_row=2000)
    assert not np.array_equal(d1["ids"], d3["ids"])


def test_shard_source_batching(tmp_path):
    paths = criteo.write_synthetic_shards(str(tmp_path), 1000, 4)
    src = loader.ShardSource(paths, batch_size=64, seed=1, num_epochs=1)
    batches = list(src)
    assert all(b["ids"].shape == (64, 39) for b in batches)
    # 1000 rows → 15 full batches (carry across shards, remainder dropped)
    assert len(batches) == 15
    # two epochs with same seed produce same first batch
    src2 = loader.ShardSource(paths, batch_size=64, seed=1, num_epochs=1)
    b2 = next(iter(src2))
    np.testing.assert_array_equal(batches[0]["ids"], b2["ids"])


def test_device_prefetch(tmp_path):
    from recsys.core.mesh import make_virtual_mesh
    env = make_virtual_mesh(8, model_axis=1)
    paths = criteo.write_synthetic_shards(str(tmp_path), 512, 2)
    src = loader.ShardSource(paths, batch_size=64, num_epochs=1)
    out = list(loader.device_prefetch(iter(src), env))
    assert len(out) == 8
    assert out[0]["ids"].shape == (64, 39)
    # sharded over the data axis
    assert len(out[0]["ids"].sharding.device_set) == 8


def test_synthetic_bayes_ceiling():
    """True-probability metrics beat any trained model and are deterministic."""
    from recsys.data.criteo import synthetic_bayes_metrics

    m1 = synthetic_bayes_metrics(20000, start_row=0)
    m2 = synthetic_bayes_metrics(20000, start_row=0)
    assert m1 == m2
    assert 0.80 < m1["auc"] < 0.95
    assert 0.3 < m1["logloss"] < 0.6
    # the "_true_prob" key never leaks into the training dict
    from recsys.data.criteo import synthetic_criteo
    assert set(synthetic_criteo(64).keys()) == {"ids", "dense", "label"}


def test_device_prefetch_reraises_producer_error():
    """A failure while generating batches (e.g. the SPMD driver's mid-stream
    a2a overflow check) reaches the consumer after the batches before it,
    instead of ending the stream as if it were complete."""
    from recsys.core.mesh import make_virtual_mesh
    env = make_virtual_mesh(8, model_axis=1)

    def gen():
        for i in range(2):
            yield {"x": np.full((8, 2), i, np.float32)}
        raise ValueError("a2a overflow mid-stream")

    it = loader.device_prefetch(gen(), env)
    assert float(next(it)["x"][0, 0]) == 0.0
    assert float(next(it)["x"][0, 0]) == 1.0
    with pytest.raises(ValueError, match="a2a overflow"):
        next(it)


def test_device_prefetch_reraises_transfer_error():
    """A failed host→device transfer raises in the consumer instead of
    leaving it blocked on the queue forever."""
    from recsys.core.mesh import make_virtual_mesh
    env = make_virtual_mesh(8, model_axis=1)
    # 7 rows cannot be split over an 8-way 'data' axis: device_put raises
    batches = iter([{"x": np.zeros((7, 2), np.float32)}])
    with pytest.raises(ValueError):
        list(loader.device_prefetch(batches, env))
