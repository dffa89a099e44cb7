"""Serving clients: REST + gRPC, with the reference's latency/AUC check.

Parity with deepfm/grpc_client.py: build a feature batch, send a warm-up
request (grpc_client.py:61-67), time the predict round trip
(grpc_client.py:79-81), then recompute AUC on the returned probabilities
against held-out labels (grpc_client.py:85) — the reference's end-to-end
export/serve sanity test (SURVEY §4). rest_client.py:17-31 parity for JSON.
"""

from __future__ import annotations

import json
import time
import urllib.request

import numpy as np

from recsys.serve.server import GRPC_METHOD


def features_to_instances(features: dict[str, np.ndarray]) -> list[dict]:
    keys = list(features.keys())
    n = len(features[keys[0]])
    return [
        {k: np.asarray(features[k][i]).tolist() for k in keys}
        for i in range(n)
    ]


def prepare_body(features: dict[str, np.ndarray],
                 binary: bool = False, fmt: str | None = None) -> bytes:
    """Pre-serialize a request — the reference client also builds its
    Examples before timing (grpc_client.py:41-54), so latency benchmarks
    should time only the round trip. ``binary=True`` (or fmt='npz') uses the
    NPZ1 columnar format (server.BINARY_MAGIC), the cheap-parse analog of
    protobuf; fmt='raw' uses the zero-copy RAW1 layout (server.RAW_MAGIC),
    the latency-path format."""
    if fmt is None:
        fmt = "npz" if binary else "json"
    if fmt == "raw":
        from recsys.serve.server import encode_raw
        return encode_raw(features)
    if fmt == "npz":
        import io
        from recsys.serve.server import BINARY_MAGIC
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in features.items()})
        return BINARY_MAGIC + buf.getvalue()
    return json.dumps({"instances": features_to_instances(features)}).encode()


def _parse_response(raw: bytes) -> np.ndarray:
    from recsys.serve.server import BINARY_MAGIC, RAW_MAGIC, parse_raw
    if raw[:4] == RAW_MAGIC:
        return parse_raw(raw)["predictions"]
    if raw[:4] == BINARY_MAGIC:
        import io
        with np.load(io.BytesIO(raw[4:])) as z:
            return z["predictions"].astype(np.float32)
    out = json.loads(raw)
    if "error" in out:
        raise RuntimeError(out["error"])
    return np.asarray(out["predictions"], np.float32)


def rest_send(port: int, body: bytes, model_name: str = "model") -> np.ndarray:
    """POST a prepared request body (JSON or NPZ1) and parse the response."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{model_name}:predict",
        data=body, headers={"Content-Type": "application/octet-stream"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return _parse_response(resp.read())


def make_grpc_stub(port: int):
    """One channel + stub held across calls (grpc_client.py:58-59)."""
    import grpc

    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    return channel.unary_unary(
        GRPC_METHOD,
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )


def grpc_send(stub, body: bytes) -> np.ndarray:
    return _parse_response(stub(body, timeout=30.0))


def grpc_send_future(stub, body: bytes):
    """Async predict: fire the request, return a handle (the reference
    client's ``stub.Predict.future(request, 10.0)`` pattern,
    deepfm/grpc_client.py:80). Resolve with `grpc_future_result`."""
    return stub.future(body, timeout=30.0)


def grpc_future_result(future) -> np.ndarray:
    return _parse_response(future.result())


def grpc_predict_pipelined(stub, bodies: list[bytes]) -> list[np.ndarray]:
    """Overlap N in-flight predicts on one channel: all requests go out
    before any response is awaited (what the reference's future-based
    client enables); the server's micro-batcher coalesces them into fewer
    device calls."""
    futures = [grpc_send_future(stub, b) for b in bodies]
    return [grpc_future_result(f) for f in futures]


def rest_predict(port: int, features: dict[str, np.ndarray],
                 model_name: str = "model") -> np.ndarray:
    body = json.dumps({"instances": features_to_instances(features)}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{model_name}:predict",
        data=body, headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        out = json.loads(resp.read())
    if "error" in out:
        raise RuntimeError(out["error"])
    return np.asarray(out["predictions"], np.float32)


def grpc_predict(port: int, features: dict[str, np.ndarray]) -> np.ndarray:
    import grpc

    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    stub = channel.unary_unary(
        GRPC_METHOD,
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )
    body = json.dumps({"instances": features_to_instances(features)}).encode()
    resp = stub(body, timeout=30.0)
    return np.asarray(json.loads(resp)["predictions"], np.float32)


def benchmark_serving(
    predict_fn, features: dict[str, np.ndarray],
    labels: np.ndarray | None = None, warmup: int = 2, iters: int = 10,
) -> dict[str, float]:
    """Warm-up + timed predicts + optional AUC check → latency stats."""
    for _ in range(warmup):
        predict_fn(features)
    lat = []
    probs = None
    for _ in range(iters):
        t0 = time.perf_counter()
        probs = predict_fn(features)
        lat.append(time.perf_counter() - t0)
    out = {
        "batch": float(len(probs)),
        "latency_ms_mean": float(np.mean(lat) * 1e3),
        "latency_ms_p50": float(np.percentile(lat, 50) * 1e3),
        "latency_ms_p99": float(np.percentile(lat, 99) * 1e3),
    }
    if labels is not None and len(set(labels.tolist())) > 1:
        from recsys.train.metrics import roc_auc
        out["auc"] = float(roc_auc(labels, probs))
    return out
