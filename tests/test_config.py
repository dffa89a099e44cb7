"""Config system: overrides, statics, mesh helpers (SURVEY §5.6)."""

import numpy as np
import pytest

from recsys.core import mesh as M
from recsys.core.config import (
    CRITEO_CAT_VOCABS, CRITEO_CAT_VOCABS_FULL, CriteoConfig, RunConfig,
    apply_overrides, cont_bucket_sizes, to_json,
)


def test_criteo_statics_match_reference():
    # fm/fm.py:72-73 — 26 capped vocabs, six fields capped at 100k
    assert len(CRITEO_CAT_VOCABS) == 26
    assert CRITEO_CAT_VOCABS.count(100000) == 7
    assert len(CRITEO_CAT_VOCABS_FULL) == 26
    assert max(CRITEO_CAT_VOCABS_FULL) == 10131226
    # 13 bucket lists (fm/fm.py:54-67)
    assert len(cont_bucket_sizes()) == 13
    cfg = CriteoConfig()
    assert len(cfg.field_vocab_sizes) == 39
    assert cfg.total_vocab == sum(cfg.field_vocab_sizes)


def test_apply_overrides():
    cfg = RunConfig()
    out = apply_overrides(cfg, [
        "--train.batch_size=8192",
        "--model.name=dcn",
        "--model.deep_layers=64,32",
        "--train.learning_rate=0.01",
    ])
    assert out.train.batch_size == 8192
    assert out.model.name == "dcn"
    assert out.model.deep_layers == (64, 32)
    assert abs(out.train.learning_rate - 0.01) < 1e-12
    # original untouched (frozen dataclasses)
    assert cfg.train.batch_size == 256
    with pytest.raises(ValueError):
        apply_overrides(cfg, ["--train.nope=1"])
    assert "batch_size" in to_json(out.train)


def test_host_shard_assignment():
    files = [f"part-{i}" for i in range(10)]
    s0 = M.host_shard_of(files, 0, 4)
    s1 = M.host_shard_of(files, 1, 4)
    all_shards = sorted(sum((M.host_shard_of(files, i, 4) for i in range(4)),
                            []))
    assert all_shards == sorted(files)           # partition, no overlap
    assert not set(s0) & set(s1)


def test_make_mesh_shapes():
    env = M.make_virtual_mesh(8, model_axis=2)
    assert env.num_data == 4 and env.num_model == 2
    assert env.mesh.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        M.make_mesh(M.MeshConfig(data_axis=3, model_axis=3))
