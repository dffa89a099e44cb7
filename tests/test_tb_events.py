"""The hand-encoded tfevents writer must produce files stock TensorBoard
can read — validated against tensorboard's own event loader (pure reader;
the writer keeps zero TF/TB dependencies). Reference artifact being
reproduced: RunConfig summary streams (deepfm/deepfm.py:166-167) and
VAE-CF's scalar+histogram summaries (vae-cf/vae_cf_train_val.py:129-144)."""

import glob
import os

import numpy as np
import pytest

from recsys.train import summaries, tb_events

tb_loader = pytest.importorskip(
    "tensorboard.backend.event_processing.event_file_loader")


def _load_events(path):
    return list(tb_loader.LegacyEventFileLoader(path).Load())


def test_crc32c_known_vectors():
    # RFC 3720 test vectors for CRC32C (Castagnoli)
    assert tb_events.crc32c(b"") == 0x0
    assert tb_events.crc32c(b"123456789") == 0xE3069283
    assert tb_events.crc32c(bytes(32)) == 0x8A9136AA


def test_event_file_round_trips_through_tensorboard_loader(tmp_path):
    w = tb_events.EventWriter(str(tmp_path))
    w.add_scalar("loss", 0.5, step=1)
    w.add_scalar("loss", 0.25, step=2)
    w.add_scalars({"auc": 0.8, "logloss": 0.45}, step=2)
    w.add_histogram("weights", np.linspace(-1, 1, 100), step=2)
    w.close()

    events = _load_events(w.path)
    assert events[0].file_version == "brain.Event:2"
    scalars = [(v.tag, e.step, v.simple_value)
               for e in events for v in e.summary.value
               if v.HasField("simple_value")]
    assert ("loss", 1, 0.5) in scalars
    assert ("loss", 2, 0.25) in scalars
    tags = {t for t, _, _ in scalars}
    assert {"auc", "logloss"} <= tags

    histos = [v.histo for e in events for v in e.summary.value
              if v.HasField("histo")]
    assert len(histos) == 1
    h = histos[0]
    assert h.num == 100
    assert h.min == pytest.approx(-1.0)
    assert h.max == pytest.approx(1.0)
    assert sum(h.bucket) == pytest.approx(100)
    assert len(h.bucket_limit) == len(h.bucket)


def test_scalar_writer_tees_tb(tmp_path):
    d = str(tmp_path / "run")
    with summaries.ScalarWriter(d) as w:
        w.write(10, loss=1.5, eval_auc=0.7)
        w.write_histogram(10, "emb", np.arange(8.0))
    # JSONL intact
    recs = summaries.read_scalars(d)
    assert recs[0]["loss"] == 1.5
    # a tfevents file exists and parses
    ev_files = glob.glob(os.path.join(d, "events.out.tfevents.*"))
    assert len(ev_files) == 1
    events = _load_events(ev_files[0])
    tags = {v.tag for e in events for v in e.summary.value}
    assert {"loss", "eval_auc", "emb"} <= tags


def test_jsonl_converter(tmp_path):
    d = str(tmp_path / "run")
    with summaries.ScalarWriter(d, tb=False) as w:
        for s in range(5):
            w.write(s, loss=float(5 - s))
    path = tb_events.jsonl_to_events(d)
    events = _load_events(path)
    scalars = [(e.step, v.simple_value) for e in events
               for v in e.summary.value if v.tag == "loss"]
    assert scalars == [(s, float(5 - s)) for s in range(5)]
