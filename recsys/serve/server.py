"""Serving front-ends: REST (TF-Serving-style JSON) + gRPC, with batching.

Replaces ``tensorflow_model_server`` (the C++ server the reference's clients
talk to, deepfm/grpc_client.py:11-14, deepfm/rest_client.py:1-2) with a
lightweight host around the jitted inference function:

- REST: ``POST /v1/models/<name>:predict`` with ``{"instances": [...]}`` →
  ``{"predictions": [...]}`` — the same JSON surface the reference REST
  client uses (rest_client.py:17-31).
- gRPC: a generic bytes-unary method ``/recsys.Predictor/Predict`` carrying
  the same JSON payload (no protoc needed; the runtime is stock grpcio, and
  the endpoint is left out where grpcio is not installed).
- A micro-batching queue coalesces concurrent requests into one device call
  (the request-batching TF-Serving does natively, SURVEY §2.2 last row).

Feature payloads: each instance is ``{"ids": [39 ints], "dense": [13
floats]}`` for Criteo models (the post-preprocessing schema; raw-TSV
preprocessing belongs to the offline/data tier as in the reference, whose
exported graph also consumes already-serialized Examples).
"""

from __future__ import annotations

import json
import queue
import threading
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from recsys.serve.export import Servable


class _MicroBatcher:
    """Coalesce concurrent predict calls into single device invocations.

    Batching is *opportunistic* by default (``timeout_ms=0``): a request
    never waits for company — whatever is already queued when the worker
    picks up a request rides the same device call. Under concurrent load
    requests accumulate while a device call is in flight, so batches form
    naturally without adding idle latency to a lone caller (TF-Serving's
    ``batch_timeout_micros=0`` behavior). Set ``timeout_ms>0`` to trade
    single-request latency for bigger coalesced batches."""

    def __init__(self, servable: Servable, max_batch: int = 4096,
                 timeout_ms: float = 0.0):
        self.servable = servable
        self.max_batch = max_batch
        self.timeout_s = timeout_ms / 1000.0
        self.q: queue.Queue = queue.Queue()
        self._inline = threading.Lock()
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def predict(self, features: dict[str, np.ndarray]) -> np.ndarray:
        # Uncontended fast path: nothing queued and no inline call running →
        # predict on the caller thread. The queue+event handoff costs two
        # scheduler wake-ups (~1-3 ms under GIL pressure); a lone request
        # should not pay it. Under load the lock is held / the queue is
        # non-empty, so requests fall through to the coalescing worker.
        if self.q.empty() and self._inline.acquire(blocking=False):
            try:
                return self.servable.predict(features)
            finally:
                self._inline.release()
        ev = threading.Event()
        slot: dict = {"features": features, "event": ev}
        self.q.put(slot)
        ev.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def _loop(self):
        while not self._stop:
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            group = [first]
            n = len(next(iter(first["features"].values())))
            while n < self.max_batch:
                try:
                    nxt = (self.q.get_nowait() if self.timeout_s <= 0
                           else self.q.get(timeout=self.timeout_s))
                except queue.Empty:
                    break
                group.append(nxt)
                n += len(next(iter(nxt["features"].values())))
            try:
                keys = first["features"].keys()
                merged = {
                    k: np.concatenate([g["features"][k] for g in group])
                    for k in keys
                }
                probs = self.servable.predict(merged)
                lo = 0
                for g in group:
                    cnt = len(next(iter(g["features"].values())))
                    g["result"] = probs[lo:lo + cnt]
                    lo += cnt
            except Exception as e:  # propagate per-request
                for g in group:
                    g["error"] = f"{type(e).__name__}: {e}"
            finally:
                for g in group:
                    g["event"].set()

    def stop(self):
        self._stop = True


#: magic prefix for the binary columnar payload (client-side np.savez of the
#: feature dict) — the cheap-parse analog of TF-Serving's protobuf Examples;
#: JSON instance lists remain the default wire format.
BINARY_MAGIC = b"NPZ1"

#: zero-copy columnar payload: fixed little-endian header + raw array bytes.
#: np.savez builds a zipfile per request (~0.2 ms parse at batch 200); RAW1
#: parses with np.frombuffer views in ~10 µs — the latency-path format.
#: Layout: b"RAW1" | u8 n_arrays | per array: [u8 name_len | name utf-8 |
#: u8 dtype_char ('i'=int32,'f'=float32) | u8 ndim | u32×ndim dims] |
#: concatenated C-order array buffers.
RAW_MAGIC = b"RAW1"

_RAW_DTYPES = {"i": np.dtype("<i4"), "f": np.dtype("<f4")}


def encode_raw(arrays: dict[str, np.ndarray]) -> bytes:
    import struct
    head = [RAW_MAGIC, bytes([len(arrays)])]
    bufs = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.kind in "iu":
            arr, ch = arr.astype("<i4", copy=False), b"i"
        else:
            arr, ch = arr.astype("<f4", copy=False), b"f"
        nb = name.encode()
        head.append(bytes([len(nb)]) + nb + ch + bytes([arr.ndim])
                    + struct.pack(f"<{arr.ndim}I", *arr.shape))
        bufs.append(arr.tobytes())
    return b"".join(head) + b"".join(bufs)


def parse_raw(body: bytes) -> dict[str, np.ndarray]:
    import struct
    n_arrays = body[4]
    pos = 5
    metas = []
    for _ in range(n_arrays):
        nlen = body[pos]; pos += 1
        name = body[pos:pos + nlen].decode(); pos += nlen
        ch = chr(body[pos]); pos += 1
        ndim = body[pos]; pos += 1
        shape = struct.unpack_from(f"<{ndim}I", body, pos); pos += 4 * ndim
        metas.append((name, _RAW_DTYPES[ch], shape))
    out = {}
    for name, dt, shape in metas:
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out[name] = np.frombuffer(body, dt, count, pos).reshape(shape)
        pos += count * dt.itemsize
    return out


def parse_request(body: bytes) -> tuple[dict[str, np.ndarray], str]:
    """bytes → (features, fmt) with fmt in {'json','npz','raw'}."""
    if body[:4] == RAW_MAGIC:
        return parse_raw(body), "raw"
    if body[:4] == BINARY_MAGIC:
        import io
        with np.load(io.BytesIO(body[4:])) as z:
            return {k: z[k] for k in z.files}, "npz"
    return _instances_to_features(json.loads(body)["instances"]), "json"


def encode_response(probs: np.ndarray, fmt) -> bytes:
    """``fmt``: 'json' | 'npz' | 'raw' (bools accepted for backward compat:
    True='npz', False='json')."""
    if fmt is True:
        fmt = "npz"
    elif fmt is False:
        fmt = "json"
    if fmt == "raw":
        return encode_raw({"predictions": np.asarray(probs, np.float32)})
    if fmt == "npz":
        import io
        buf = io.BytesIO()
        np.savez(buf, predictions=np.asarray(probs, np.float32))
        return BINARY_MAGIC + buf.getvalue()
    return json.dumps({"predictions": [float(p) for p in probs]}).encode()


def _instances_to_features(instances: list[dict]) -> dict[str, np.ndarray]:
    keys = instances[0].keys()
    feats = {}
    for k in keys:
        arr = np.asarray([inst[k] for inst in instances])
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int32)
        elif arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        feats[k] = arr
    return feats


# ---------------------------------------------------------------------------
# REST
# ---------------------------------------------------------------------------

def make_rest_server(servable: Servable, port: int,
                     batcher: _MicroBatcher | None = None):
    batcher = batcher or _MicroBatcher(servable)
    model_name = servable.model_name

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                feats, binary = parse_request(self.rfile.read(length))
                probs = batcher.predict(feats)
                out = encode_response(probs, binary)
                self.send_response(200)
            except Exception as e:
                out = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                self.send_response(400)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def do_GET(self):
            # model status endpoint
            out = json.dumps({
                "model_version_status": [{
                    "version": "1", "state": "AVAILABLE",
                    "model_name": model_name,
                }]
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    return server, batcher


# ---------------------------------------------------------------------------
# gRPC (generic method, JSON payload — no protoc required)
# ---------------------------------------------------------------------------

GRPC_METHOD = "/recsys.Predictor/Predict"


def make_grpc_server(servable: Servable, port: int,
                     batcher: _MicroBatcher | None = None):
    import grpc

    batcher = batcher or _MicroBatcher(servable)

    def predict_handler(request_bytes: bytes, context) -> bytes:
        feats, binary = parse_request(request_bytes)
        probs = batcher.predict(feats)
        return encode_response(probs, binary)

    handler = grpc.method_handlers_generic_handler(
        "recsys.Predictor",
        {
            "Predict": grpc.unary_unary_rpc_method_handler(
                predict_handler,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            )
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers((handler,))
    server.add_insecure_port(f"127.0.0.1:{port}")
    return server, batcher


# ---------------------------------------------------------------------------
# All front-ends on one micro-batcher
# ---------------------------------------------------------------------------

def start_servers(servable: Servable, port: int):
    """Start REST on ``port`` (0 binds a free one), gRPC on the next port
    where grpcio imports, and the socket server on the one after, each on
    daemon threads over one shared micro-batcher.

    Returns (endpoints, stop): ``endpoints`` maps each front-end that is up
    to its port; ``stop()`` shuts them all down."""
    from recsys.serve.fastsock import SocketServer

    rest, batcher = make_rest_server(servable, port)
    port = rest.server_address[1]
    threading.Thread(target=rest.serve_forever, daemon=True).start()
    endpoints = {"REST": port}
    stops = [rest.shutdown, rest.server_close, batcher.stop]
    try:
        grpc_srv, _ = make_grpc_server(servable, port + 1, batcher)
    except ImportError:
        pass
    else:
        grpc_srv.start()
        endpoints["gRPC"] = port + 1
        stops.append(lambda: grpc_srv.stop(0))
    sock = SocketServer(servable, port + 2, batcher)
    sock.start()
    endpoints["socket"] = port + 2
    stops.append(sock.shutdown)

    def stop():
        for f in stops:
            f()

    return endpoints, stop
