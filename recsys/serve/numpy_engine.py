"""Pure-NumPy inference path for latency-mode serving.

Why this exists: XLA:CPU is a throughput compiler — on a small host every
compiled op pays tens of microseconds of threadpool dispatch, so the jitted
CTR forward at serving batch sizes costs ~300-500 µs regardless of its
~5 MFLOP of real work (measured: one 256×100×100 relu matmul thunk alone
p50 ≈ 100 µs while the math is ~5 µs). TF-Serving's CPU session — the
reference's 0.29 ms @ batch 200 surface (deepfm/readme.md:64-73) — has the
same shape-static graph but a cheaper executor. For latency serving the
answer here is: keep the big-batch/throughput path on the jitted
(accelerator or XLA:CPU) Servable, and run the small-batch latency path as
straight-line NumPy/BLAS in-process — zero per-op dispatch, no padding to
bucket shapes, thread-safe (read-only params).

`NumpyPredictor` mirrors the exact inference math of the CTR zoo
(models/ctr.py apply bodies with ``train=False``) over the engine param
layouts of embeddings/engines.py (SplitEngine small+big / FusedGatherEngine
packed), with BatchNorm folded to a single affine at load time. Parity with
the jitted path is pinned to ~1e-5 by tests/test_numpy_engine.py.

Supported models: fm, deepfm, dnn, dcn, xdeepfm, wide. Others (DIN, CF)
raise — they stay on the jitted Servable path.
"""

from __future__ import annotations

import numpy as np

from recsys.core.config import CriteoConfig, ModelConfig
from recsys.embeddings import table as emb_table

BN_EPS = 1e-3   # ops/nn.py BN_EPS (tf.layers default)


def _np(tree):
    """Pytree → contiguous float32/struct numpy mirror."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.ascontiguousarray(np.asarray(tree))


def _fold_mlp(mlp_params: dict, mlp_state: dict) -> list[dict]:
    """[dense→relu→BN]×L with BN (inference) prefolded to y = h*a + c."""
    layers = []
    for i, lp in enumerate(mlp_params["layers"]):
        layer = {"w": lp["dense"]["w"], "b": lp["dense"]["b"]}
        if "bn" in lp:
            ls = mlp_state["layers"][i]["bn"]
            a = lp["bn"]["scale"] / np.sqrt(ls["var"] + BN_EPS)
            layer["bn_a"] = a.astype(np.float32)
            layer["bn_c"] = (lp["bn"]["offset"] - ls["mean"] * a).astype(
                np.float32)
        layers.append(layer)
    return layers


def _sigmoid_(logits: np.ndarray) -> np.ndarray:
    """In-place sigmoid of a fresh logits array."""
    np.negative(logits, out=logits)
    np.exp(logits, out=logits)
    logits += 1.0
    np.reciprocal(logits, out=logits)
    return logits


def _mlp(layers: list[dict], x: np.ndarray) -> np.ndarray:
    """In-place tail ops on the fresh dot output: one allocation per layer
    (the latency path is numpy-dispatch/alloc-bound, not FLOP-bound)."""
    h = x
    for l in layers:
        h = np.dot(h, l["w"])
        h += l["b"]
        np.maximum(h, 0.0, out=h)
        if "bn_a" in l:
            h *= l["bn_a"]
            h += l["bn_c"]
    return h


def _dense(p: dict, x: np.ndarray, relu: bool = False) -> np.ndarray:
    y = np.dot(x, p["w"])
    y += p["b"]
    if relu:
        np.maximum(y, 0.0, out=y)
    return y


class NumpyPredictor:
    """probs = f(features) as straight-line NumPy over exported params."""

    def __init__(self, model_name: str, criteo_cfg: CriteoConfig,
                 model_cfg: ModelConfig, model, params, state):
        if model_name not in ("fm", "deepfm", "dnn", "dcn", "xdeepfm",
                              "wide"):
            raise NotImplementedError(
                f"numpy latency engine supports the CTR zoo, not "
                f"{model_name!r}")
        self.name = model_name
        self.cfg = model_cfg
        self.criteo = criteo_cfg
        p = _np(params)
        s = _np(state)
        self.p = p
        d = model_cfg.embedding_dim
        self.dim = d

        if model_name == "wide":
            # models/ctr.py make_wide: packed per-row weight over ORIGINAL
            # field offsets
            self.offsets = emb_table.field_offsets(
                criteo_cfg.field_vocab_sizes).astype(np.int64)
            self.w_wide = p["wide"]["w"]
            self.b_wide = p["wide"]["b"]
            return

        # --- embedding engine mirror (engines.py) -----------------------
        engine = model.meta["engine"]
        tables = p["tables"]
        self.b_tab = tables["b"]
        self.small = None
        self.big = None
        if "table_flat" in tables:       # FusedGatherEngine
            w = d + 1
            v_pad = engine.v_pad
            self.big = {
                "rows": tables["table_flat"].reshape(v_pad, w),
                "offsets": np.asarray(engine.offsets, np.int64),
                "fields": np.arange(len(criteo_cfg.field_vocab_sizes)),
            }
            self.field_order = engine.field_order
        else:                            # SplitEngine
            small_f, big_f = engine._partition()
            self.field_order = engine.field_order
            if small_f:
                sizes = engine._sizes(small_f)
                self.small = {
                    "rows": tables["small"],     # [Vs, D+1]
                    "offsets": emb_table.field_offsets(sizes).astype(
                        np.int64),
                    "fields": np.asarray(small_f),
                }
            if big_f:
                sizes = engine._sizes(big_f)
                self.big = {
                    # storage is W-major [W, V_pad] (engines.py): transpose
                    # once at load into a contiguous row-major mirror
                    "rows": np.ascontiguousarray(tables["big_wm"].T),
                    "offsets": emb_table.field_offsets(sizes).astype(
                        np.int64),
                    "fields": np.asarray(big_f),
                }

        # --- model-specific folded params -------------------------------
        if model_name in ("deepfm", "dnn", "dcn", "xdeepfm"):
            self.mlp = _fold_mlp(p["dnn"], s["dnn"])
        if model_name == "xdeepfm":
            n_cont = len(criteo_cfg.cont_boundaries)
            self.cat_pos = np.where(self.field_order >= n_cont)[0]
            self.cin = p["cin"]

    # -- engine-order lookup: rows [B, F, D+1] ---------------------------
    def _rows(self, ids: np.ndarray) -> np.ndarray:
        parts = []
        for part in (self.small, self.big):
            if part is None:
                continue
            gids = ids[:, part["fields"]].astype(np.int64) + part["offsets"]
            parts.append(part["rows"][gids])
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)

    def __call__(self, features: dict[str, np.ndarray]) -> np.ndarray:
        ids = np.asarray(features["ids"])
        if self.name == "wide":
            gids = ids.astype(np.int64) + self.offsets
            logits = self.w_wide[gids].sum(axis=1) + self.b_wide
            return _sigmoid_(logits)

        rows = self._rows(ids)                       # [B, F, D+1] engine ord
        emb = rows[:, :, :-1]
        wide = rows[:, :, -1]
        b, f, d = emb.shape
        emb2d = emb.reshape(b, f * d)

        if self.name == "fm":
            y1 = np.maximum(wide.sum(1, keepdims=True) + self.b_tab, 0.0)
            y2 = self._fm(emb)
            logits = _dense(self.p["final"], np.concatenate([y1, y2], 1))
        elif self.name == "deepfm":
            y1 = np.maximum(wide.sum(1, keepdims=True) + self.b_tab, 0.0)
            y2 = self._fm(emb)
            y3 = _dense(self.p["dnn_out"], _mlp(self.mlp, emb2d), relu=True)
            logits = _dense(self.p["final"],
                            np.concatenate([y1, y2, y3], 1))
        elif self.name == "dnn":
            logits = _dense(self.p["final"], _mlp(self.mlp, emb2d))
        elif self.name == "dcn":
            xl = emb2d
            for layer in self.p["cross"]:
                xl = (xl @ layer["w"])[:, None] * emb2d + xl + layer["b"]
            h = _mlp(self.mlp, emb2d)
            logits = _dense(self.p["final"], np.concatenate([h, xl], 1))
        elif self.name == "xdeepfm":
            dense_vals = np.asarray(features["dense"], np.float32)
            lin = (_dense(self.p["lin_dense"], dense_vals)
                   + wide[:, self.cat_pos].sum(1, keepdims=True))
            y_lin = np.maximum(lin, 0.0)
            y_cin = _dense(self.p["cin_out"], self._cin(emb), relu=True)
            y_dnn = _dense(self.p["dnn_out"], _mlp(self.mlp, emb2d),
                           relu=True)
            logits = _dense(self.p["final"],
                            np.concatenate([y_lin, y_cin, y_dnn], 1))
        return _sigmoid_(logits[:, 0])

    @staticmethod
    def _fm(emb: np.ndarray) -> np.ndarray:
        s = emb.sum(axis=1)
        y = np.einsum("bd,bd->b", s, s)
        y -= np.einsum("bfd,bfd->b", emb, emb)
        y *= 0.5
        return y[:, None]

    def _cin(self, emb: np.ndarray) -> np.ndarray:
        """interactions.cin_apply_xla in numpy: feature maps carried as
        [B·D, F] (emb dim fused into rows) so z is a broadcast multiply."""
        b, f0, d = emb.shape
        x0 = np.transpose(emb, (0, 2, 1)).reshape(b * d, f0)
        xk = x0
        pooled = []
        for layer in self.cin:
            fk = xk.shape[1]
            z = (x0[:, :, None] * xk[:, None, :]).reshape(b * d, f0 * fk)
            xk = np.maximum(z @ layer["w"] + layer["b"], 0.0)  # [B·D, H]
            pooled.append(xk.reshape(b, d, -1).sum(axis=1))    # [B, H]
        return np.concatenate(pooled, axis=1)
