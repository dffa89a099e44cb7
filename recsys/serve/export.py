"""Model export for serving.

Replaces SavedModel export (``export_savedmodel`` — deepfm/deepfm.py:220-233,
``export_outputs`` in every model_fn, fm/fm.py:136-144): a servable is the
model config + trained (params, model_state) on disk, reloaded into a
jit-compiled inference function whose signature is the reference's serving
signature — ``prob = f(features)`` (PredictOutput{"prob"}).

Batch-size bucketing keeps serving shapes static (one compile each): incoming
requests are padded up to the next bucket, each bucket compiles once and is
cached by jit.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np

from recsys.core.checkpoint import CheckpointManager
from recsys.core.config import CriteoConfig, ModelConfig
from recsys.models.api import make_model
from recsys.train.train_state import make_predict_step

DEFAULT_BUCKETS = (1, 8, 64, 256, 1024, 4096)


def export_servable(
    export_dir: str,
    model_name: str,
    params,
    model_state,
    model_cfg: ModelConfig,
    criteo_cfg: CriteoConfig | None = None,
    extra: dict | None = None,
    factory_kwargs: dict | None = None,
) -> str:
    """``factory_kwargs`` are forwarded to the model factory at load time
    (e.g. DIN's item_vocab/cate_vocab) so the reconstructed parameter
    shapes match the exported weights exactly."""
    os.makedirs(export_dir, exist_ok=True)
    mgr = CheckpointManager(export_dir, keep_max=1)
    mgr.save(0, (params, model_state), extra=extra)
    meta = {
        "model_name": model_name,
        "model_cfg": dataclasses.asdict(model_cfg),
        "criteo_cfg": dataclasses.asdict(criteo_cfg) if criteo_cfg else None,
        "factory_kwargs": factory_kwargs or {},
    }
    with open(os.path.join(export_dir, "servable.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return export_dir


def _cfg_from_dict(cls, d):
    if d is None:
        return None
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kw[k] = v
    return cls(**kw)


class Servable:
    """Loaded inference endpoint with bucketed static batch shapes.

    Thread-safety contract: `predict` MUST be safe to call concurrently
    from multiple threads. The server's micro-batcher relies on this — its
    inline fast path (serve/server.py `_MicroBatcher.predict`) runs
    `predict` on the caller's thread while the worker thread may be
    executing a coalesced batch at the same time. This implementation
    satisfies the contract because predict is stateless around a jitted
    call (jax compiled functions are thread-safe); any future stateful
    Servable must add its own synchronization or disable the inline path.
    """

    def __init__(self, export_dir: str,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 engine: str = "jit"):
        """``engine``: 'jit' (default — XLA on the default device) or
        'numpy' (straight-line NumPy/BLAS — the CPU latency path, no per-op
        dispatch, no bucket padding; see serve/numpy_engine.py)."""
        with open(os.path.join(export_dir, "servable.json")) as f:
            meta = json.load(f)
        self.model_name = meta["model_name"]
        model_cfg = _cfg_from_dict(ModelConfig, meta["model_cfg"])
        criteo_cfg = _cfg_from_dict(CriteoConfig, meta["criteo_cfg"])
        self.criteo_cfg = criteo_cfg
        kwargs = meta.get("factory_kwargs") or {}
        if criteo_cfg is not None:
            self.model = make_model(self.model_name, criteo_cfg, model_cfg,
                                    **kwargs)
        else:
            self.model = make_model(self.model_name, cfg=model_cfg, **kwargs)
        params_t, state_t = self.model.init(jax.random.key(0))
        mgr = CheckpointManager(export_dir, keep_max=1)
        restored = mgr.restore((params_t, state_t))
        if restored is None:
            raise FileNotFoundError(f"no weights in {export_dir}")
        (self.params, self.model_state), _, _ = restored
        self.params = jax.tree.map(jax.numpy.asarray, self.params)
        self.model_state = jax.tree.map(jax.numpy.asarray, self.model_state)
        self.buckets = buckets
        self._predict = make_predict_step(self.model)
        # input-signature → AOT-compiled executable
        # (jax.jit(...).lower().compile() skips the python jit-dispatch
        # machinery, ~0.1 ms per call on CPU). Keyed on the full padded
        # aval signature, not just the bucket size, so requests with a
        # different feature layout never hit a mismatched executable.
        self._compiled: dict[tuple, object] = {}
        self.engine = engine
        self._np_predict = None
        if engine == "numpy":
            from recsys.serve.numpy_engine import NumpyPredictor
            self._np_predict = NumpyPredictor(
                self.model_name, self.criteo_cfg, model_cfg, self.model,
                self.params, self.model_state)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return ((n + self.buckets[-1] - 1) // self.buckets[-1]) * self.buckets[-1]

    @staticmethod
    def _sig(padded: dict) -> tuple:
        return tuple(sorted(
            (k, v.shape, v.dtype.str) for k, v in padded.items()))

    def predict(self, features: dict[str, np.ndarray]) -> np.ndarray:
        """features → probs [B] (the "prob" serving output)."""
        if self._np_predict is not None:
            return np.asarray(self._np_predict(features), np.float32)
        n = len(next(iter(features.values())))
        b = self._bucket(n)
        padded = {}
        for k, v in features.items():
            v = np.asarray(v)
            if v.dtype.kind in "iu":
                v = v.astype(np.int32, copy=False)
            elif v.dtype != np.float32:
                v = v.astype(np.float32)
            if b > n:
                pad = np.repeat(v[-1:], b - n, axis=0)
                v = np.concatenate([v, pad], axis=0)
            padded[k] = v
        sig = self._sig(padded)
        fn = self._compiled.get(sig)
        if fn is None:
            fn = self._predict.lower(
                self.params, self.model_state, padded).compile()
            self._compiled[sig] = fn
        probs = fn(self.params, self.model_state, padded)
        return np.asarray(probs)[:n]

    def warmup(self) -> None:
        """Pre-compile all buckets (the reference's warm-up request,
        grpc_client.py:61-67, generalized). NumPy engine: nothing to
        compile."""
        if self._np_predict is not None:
            return
        sample = self._sample_features(1)
        for b in self.buckets:
            feats = {k: np.repeat(v, b, axis=0) for k, v in sample.items()}
            self.predict(feats)

    def _sample_features(self, n: int) -> dict[str, np.ndarray]:
        if self.criteo_cfg is not None:
            from recsys.data.criteo import synthetic_criteo
            d = synthetic_criteo(n, self.criteo_cfg)
            return {k: v for k, v in d.items() if k != "label"}
        # non-Criteo models (DIN, CF) declare their warmup feature
        # generator in Model.meta (the reference exports every estimator
        # model the same way, deepfm/deepfm.py:220-233)
        fn = self.model.meta.get("sample_features")
        if fn is None:
            raise NotImplementedError(
                f"model {self.model_name} declares no sample_features"
            )
        return fn(n)
