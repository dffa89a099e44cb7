"""Criteo data plane: offline preprocessor + synthetic generator.

Replaces the reference's Spark/Hive ETL (xdeepfm/writer.py:19-40,
xdeepfm/gen_tfrecords.py:12-40 — TSV → Hive → mean-imputed TFRecord shards)
and the per-script ``tf.feature_column`` *statics* with a self-contained
pipeline:

    raw TSV  ──preprocess──►  sharded .npz parts, each holding
        ids:   int32  [N, 39]  field-local ids (13 bucketized cont + 26 hashed cat)
        dense: float32 [N, 13] log-scaled continuous values
        label: float32 [N]

Feature semantics (parity map):
- continuous missing → column mean (Spark Imputer, gen_tfrecords.py:25-31);
- log transform log(x + 1), except _c2 which uses log(x + 4)
  (fm/fm.py:76-78); negatives clamped to 0 before the log (the reference
  would produce NaNs on Criteo's small negative values);
- bucketization against the reference's quantile boundaries
  (fm/fm.py:54-67). NOTE the reference, via TF feature_column ordering,
  bucketizes the *log-normalized* value against *raw-scale* boundaries,
  which degenerates the wide-range fields to one bucket; we bucketize the
  raw imputed value (the boundaries' intended scale). Set
  ``bucketize_log=True`` to reproduce the reference quirk exactly.
- categorical missing → 'NULL' token then hashed (fm/fm.py:44), hashing per
  `recsys.data.hashing` with the 100k-capped vocabs (fm/fm.py:72-73).

The synthetic generator plants a sparse logistic ground truth over the same
schema so tests/benchmarks can assert "AUC above floor" without the 11 GB
dataset (SURVEY §4d).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from recsys.core.config import CriteoConfig
from recsys.data import hashing


# ---------------------------------------------------------------------------
# Transform core (shared by offline preprocess and streaming loaders)
# ---------------------------------------------------------------------------

def log_transform(values: np.ndarray, cfg: CriteoConfig) -> np.ndarray:
    """[N, 13] imputed raw → log-scaled. _c2 (index 1) uses shift 4."""
    shifts = np.full((values.shape[1],), cfg.log_shift_default, np.float32)
    shifts[1] = cfg.log_shift_c2
    return np.log(np.maximum(values, 0.0) + shifts).astype(np.float32)


def bucketize_cont(
    values: np.ndarray, cfg: CriteoConfig, bucketize_log: bool = False
) -> np.ndarray:
    """[N, 13] imputed raw → int32 bucket ids via the reference boundaries."""
    src = log_transform(values, cfg) if bucketize_log else values
    out = np.empty(src.shape, np.int32)
    for j, bounds in enumerate(cfg.cont_boundaries):
        out[:, j] = np.searchsorted(np.asarray(bounds), src[:, j], side="right")
    return out


def hash_cat(raw_cat: np.ndarray, cfg: CriteoConfig) -> np.ndarray:
    """[N, 26] object array of strings ('' = missing) → int32 hashed ids."""
    n = raw_cat.shape[0]
    out = np.empty((n, 26), np.int32)
    for j, vocab in enumerate(cfg.cat_vocabs):
        col = raw_cat[:, j]
        col = np.where(col == "", cfg.null_token, col)
        out[:, j] = hashing.hash_bucket_array(col, vocab)
    return out


# ---------------------------------------------------------------------------
# TSV parsing (pure-python reference path; native/criteo_parser.cc is the
# fast path, used automatically when built)
# ---------------------------------------------------------------------------

def parse_tsv_chunk(lines: list[str]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Criteo TSV (label \\t 13 ints \\t 26 hex strings) → (labels, cont
    with NaN for missing, cat object array with '' for missing)."""
    n = len(lines)
    labels = np.empty(n, np.float32)
    cont = np.full((n, 13), np.nan, np.float32)
    cat = np.empty((n, 26), object)
    for i, line in enumerate(lines):
        parts = line.rstrip("\n").split("\t")
        labels[i] = float(parts[0])
        for j in range(13):
            v = parts[1 + j] if 1 + j < len(parts) else ""
            cont[i, j] = float(v) if v != "" else np.nan
        for j in range(26):
            v = parts[14 + j] if 14 + j < len(parts) else ""
            cat[i, j] = v
    return labels, cont, cat


def compute_means(tsv_path: str, max_rows: int | None = None) -> np.ndarray:
    """Pass 1: per-column means of present continuous values (Spark Imputer
    mean strategy, xdeepfm/gen_tfrecords.py:25-31)."""
    sums = np.zeros(13, np.float64)
    counts = np.zeros(13, np.int64)
    with open(tsv_path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            parts = line.rstrip("\n").split("\t")
            for j in range(13):
                v = parts[1 + j] if 1 + j < len(parts) else ""
                if v != "":
                    sums[j] += float(v)
                    counts[j] += 1
    return (sums / np.maximum(counts, 1)).astype(np.float32)


def preprocess_tsv(
    tsv_path: str,
    out_dir: str,
    cfg: CriteoConfig = CriteoConfig(),
    rows_per_shard: int = 200_000,
    max_rows: int | None = None,
    means: np.ndarray | None = None,
    bucketize_log: bool = False,
) -> list[str]:
    """TSV → sharded npz parts (the L0 replacement). Returns shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    if means is None:
        means = compute_means(tsv_path, max_rows)
    np.save(os.path.join(out_dir, "cont_means.npy"), means)

    shard_paths: list[str] = []

    def parse(lines: list[str]):
        """labels, cont(NaN-missing), hashed cat ids — native fast path when
        the C++ parser is built, else the pure-python reference path."""
        from recsys.data import native
        if native.available():
            blob = "".join(lines).encode()
            labels, cont, cat_ids, _ = native.parse_criteo_bytes(
                blob, cfg.cat_vocabs, max_rows=len(lines))
            return labels, cont, cat_ids
        labels, cont, cat = parse_tsv_chunk(lines)
        return labels, cont, hash_cat(cat, cfg)

    def flush(lines: list[str]) -> None:
        labels, cont, cat_ids = parse(lines)
        cont = np.where(np.isnan(cont), means[None, :], cont)
        ids = np.concatenate(
            [bucketize_cont(cont, cfg, bucketize_log), cat_ids], axis=1,
        )
        dense = log_transform(cont, cfg)
        path = os.path.join(
            out_dir, f"part-r-{len(shard_paths):05d}.npz"
        )
        np.savez(path, ids=ids, dense=dense, label=labels)
        shard_paths.append(path)

    buf: list[str] = []
    with open(tsv_path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            buf.append(line)
            if len(buf) >= rows_per_shard:
                flush(buf)
                buf = []
    if buf:
        flush(buf)
    return shard_paths


# ---------------------------------------------------------------------------
# Synthetic Criteo (planted logistic ground truth)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SyntheticSpec:
    """Planted model:

        logit = bias + Σ_f effect_f[id_f]                      (first order)
              + Σ_{f<g} <U_f[id_f], U_g[id_g]>                 (second order)
              + w·dense                                        (linear dense)

    The second-order term is a planted rank-``interaction_rank`` latent per
    (field, id): U_f[i] ~ N(0, interaction_scale² I). It is exactly the FM
    generative model over all field pairs, so it separates hypothesis
    classes the way the reference's real-Criteo table does
    (/root/reference/README.md:20-28): a per-id additive model (wide/FTRL)
    provably cannot represent it — its ceiling is `linear_bayes_metrics`
    (data/synthetic_device.py) — while the interaction towers can: FM
    contains it exactly (emb dim ≥ rank), DCN's k cross layers span rank-k
    quadratic forms of the concatenated embedding (the ||Σ_f u_f||² part;
    the per-field −||u_f||² corrections are additive-per-id and fall to the
    linear branch), CIN builds the same pairwise products per layer, and
    MLP towers approximate it. Defaults give the second-order term std
    ≈ 1.07 vs ≈ 2.19 first-order and ≈ 0.43 dense — a linear-vs-full AUC
    gap of a few points, the synthetic analog of the reference's
    0.788-0.798 spread.
    """

    seed: int = 0
    effect_scale: float = 0.35
    dense_scale: float = 0.15
    bias: float = -1.2   # skewed label rate like Criteo (~25% positive)
    interaction_rank: int = 4
    interaction_scale: float = 0.14


def synthetic_criteo(
    num_rows: int,
    cfg: CriteoConfig = CriteoConfig(),
    spec: SyntheticSpec = SyntheticSpec(),
    start_row: int = 0,
    _return_prob: bool = False,
) -> dict[str, np.ndarray]:
    """Deterministic synthetic batch with learnable structure.

    Ids follow a zipf-like skew (realistic hot rows); labels come from a
    planted sparse-logistic model so trained AUC has a meaningful ceiling.
    ``start_row`` makes disjoint, reproducible slices for sharded loaders.
    """
    field_vocabs = cfg.field_vocab_sizes
    rng = np.random.default_rng(spec.seed + 7919 * (start_row // max(num_rows, 1) + 1))
    row_rng = np.random.default_rng([spec.seed, start_row])

    k = spec.interaction_rank
    ids = np.empty((num_rows, len(field_vocabs)), np.int32)
    logit = np.full(num_rows, spec.bias, np.float64)
    lat_sum = np.zeros((num_rows, k), np.float64)   # s = Σ_f U_f[id_f]
    lat_sq = np.zeros(num_rows, np.float64)         # Σ_f ||U_f[id_f]||²
    for f, vocab in enumerate(field_vocabs):
        # zipf-ish: draw from a power-law over the vocab
        u = row_rng.random(num_rows)
        raw = np.floor(vocab * u ** 2.2).astype(np.int64) % vocab
        ids[:, f] = raw
        eff_rng = np.random.default_rng([spec.seed, 31 * f + 1])
        effects = eff_rng.normal(0.0, spec.effect_scale, vocab)
        logit += effects[raw]
        if k and spec.interaction_scale:
            lat_rng = np.random.default_rng([spec.seed, 31 * f + 2])
            lat = lat_rng.normal(0.0, spec.interaction_scale, (vocab, k))
            rows = lat[raw]
            lat_sum += rows
            lat_sq += np.einsum("nk,nk->n", rows, rows)
    if k and spec.interaction_scale:
        # Σ_{f<g} <u_f, u_g> via the FM identity ½(||Σu||² − Σ||u||²)
        logit += 0.5 * (np.einsum("nk,nk->n", lat_sum, lat_sum) - lat_sq)

    # dense feature count follows the schema (13 for Criteo; 0 for id-only
    # schemas like the u_id/i_id demo)
    n_cont = len(cfg.cont_boundaries)
    dense = row_rng.lognormal(0.0, 1.0, (num_rows, n_cont)).astype(np.float32)
    wd_rng = np.random.default_rng([spec.seed, 999])
    w_dense = wd_rng.normal(0.0, spec.dense_scale, n_cont)
    logit += np.log1p(dense) @ w_dense

    prob = 1.0 / (1.0 + np.exp(-logit))
    label = (row_rng.random(num_rows) < prob).astype(np.float32)
    out = {
        "ids": ids,
        "dense": np.log1p(dense).astype(np.float32),
        "label": label,
    }
    if _return_prob:
        out["_true_prob"] = prob
    return out


def synthetic_bayes_metrics(
    num_rows: int,
    cfg: CriteoConfig = CriteoConfig(),
    spec: SyntheticSpec = SyntheticSpec(),
    start_row: int = 0,
) -> dict[str, float]:
    """AUC/logloss of the TRUE planted probabilities on a slice — the Bayes
    ceiling no model can beat (in expectation). Reported next to trained
    metrics so the quality tables are interpretable as distance-to-ceiling."""
    from recsys.train.metrics import roc_auc

    d = synthetic_criteo(num_rows, cfg, spec, start_row, _return_prob=True)
    p = np.clip(d["_true_prob"], 1e-12, 1 - 1e-12)
    y = d["label"]
    return {
        "auc": float(roc_auc(y, p)),
        "logloss": float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))),
    }


def write_synthetic_shards(
    out_dir: str,
    num_rows: int,
    num_shards: int,
    cfg: CriteoConfig = CriteoConfig(),
    spec: SyntheticSpec = SyntheticSpec(),
) -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    rows_per = num_rows // num_shards
    paths = []
    for s in range(num_shards):
        data = synthetic_criteo(rows_per, cfg, spec, start_row=s * rows_per)
        path = os.path.join(out_dir, f"part-r-{s:05d}.npz")
        np.savez(path, **data)
        paths.append(path)
    return paths
