"""RESULTS generator regression: tiny run produces well-formed MD + JSON."""

import json
import os

from recsys.tools.results import main


def test_results_generator_tiny(tmp_path):
    out = str(tmp_path / "RESULTS.md")
    result = main([
        "--models=fm", "--batch=512", "--steps=4", "--rows=4096",
        "--din=0", "--cf=0", "--serving=0", f"--out={out}",
    ])
    assert result["ctr"][0]["model"] == "fm"
    assert result["ctr"][0]["train_examples_per_s"] > 0
    assert 0.0 <= result["ctr"][0]["auc"] <= 1.0

    md = open(out).read()
    assert "| fm |" in md
    assert "train ex/s/chip" in md
    with open(os.path.splitext(out)[0] + ".json") as f:
        j = json.load(f)
    assert j["ctr"][0]["model"] == "fm"


def test_results_partial_rerun_patches_existing(tmp_path):
    """--models=subset merges into the existing RESULTS.json: other CTR
    rows and skipped sections survive a partial re-run."""
    out = str(tmp_path / "RESULTS.md")
    jpath = os.path.splitext(out)[0] + ".json"
    main([
        "--models=fm", "--batch=512", "--steps=4", "--rows=4096",
        "--din=0", "--cf=0", "--serving=0", f"--out={out}",
    ])
    # plant a fake section + an extra ctr row to witness the merge
    with open(jpath) as f:
        j = json.load(f)
    j["serving"] = [{"device": "cpu", "protocol": "fake", "batch": 7,
                     "latency_ms_p50": 1.0, "latency_ms_p99": 2.0,
                     "latency_ms_mean": 1.5}]
    j["ctr"].append({"model": "dnn", "auc": 0.5, "logloss": 0.7,
                     "train_examples_per_s": 123.0,
                     "eval_examples_per_s": 456.0})
    with open(jpath, "w") as f:
        json.dump(j, f)

    result = main([
        "--models=fm", "--batch=512", "--steps=4", "--rows=4096",
        "--din=0", "--cf=0", "--serving=0", f"--out={out}",
    ])
    models = [r["model"] for r in result["ctr"]]
    assert "fm" in models and "dnn" in models      # old row kept
    assert result["serving"][0]["protocol"] == "fake"  # old section kept
    md = open(out).read()
    assert "| dnn |" in md and "fake" in md
