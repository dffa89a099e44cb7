"""bench_stream stage functions on tiny data (a device run writes
STREAMING.md; this pins the mechanics on the CPU mesh)."""

import os

import numpy as np

from recsys.data import criteo
from recsys.tools import bench_stream


def test_synthetic_tsv_parses_through_preprocess(tmp_path):
    tsv = str(tmp_path / "synth.tsv")
    rate = bench_stream.write_synthetic_tsv(tsv, 1_000, seed=3)
    assert rate > 0
    lines = open(tsv).read().splitlines()
    assert len(lines) == 1_000
    # format-valid raw Criteo: label + 13 cont + 26 cat columns
    cols = lines[0].split("\t")
    assert len(cols) == 40 and cols[0] in ("0", "1")

    paths = criteo.preprocess_tsv(tsv, str(tmp_path / "shards"),
                                  rows_per_shard=400)
    assert len(paths) == 3
    with np.load(paths[0]) as z:
        assert z["ids"].shape == (400, 39)
        assert z["dense"].shape == (400, 13)
        assert np.isfinite(z["dense"]).all()
        vocabs = criteo.CriteoConfig().field_vocab_sizes
        assert (z["ids"] < np.asarray(vocabs)[None, :]).all()


def test_bench_stream_main_tiny(tmp_path, monkeypatch):
    """Full tool on a tiny dataset: all stages measure and STREAMING.md
    lands with the stage table."""
    monkeypatch.chdir(tmp_path)
    result = bench_stream.main([
        "--rows=6000", "--batch=128", "--steps_per_call=4",
        "--train_steps=8", f"--workdir={tmp_path / 'w'}",
    ])
    for key in ("s1_preprocess_rows_per_s", "s2_host_pipeline_rows_per_s",
                "s3_h2d_rows_per_s", "s4_stream_train_examples_per_s",
                "devgen_examples_per_s", "stream_vs_devgen"):
        assert result[key] > 0, (key, result)
    assert os.path.exists(tmp_path / "STREAMING.md")
    text = open(tmp_path / "STREAMING.md").read()
    assert "full streaming training" in text
