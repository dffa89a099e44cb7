"""Low-latency raw-socket serving endpoint.

The REST/gRPC fronts (serve/server.py) match the reference's TF-Serving
surfaces (deepfm/rest_client.py, deepfm/grpc_client.py); this is the
framework's fast path for latency-critical callers: a persistent TCP
connection carrying length-prefixed request/response bodies in the same
formats `server.parse_request` accepts (NPZ1 binary or TF-Serving JSON).
Cuts the per-call HTTP/grpcio framing + connection machinery (~2-3 ms of
python transport at batch 200) down to two localhost socket syscalls.

Wire format, both directions:
    [u32 big-endian body length][body bytes]
A zero-length frame from the client closes the connection. Server errors
come back as a JSON body ``{"error": ...}`` (clients raise).
"""

from __future__ import annotations

import json
import socket
import struct
import threading

import numpy as np

from recsys.serve.export import Servable
from recsys.serve.server import (
    _MicroBatcher,
    encode_response,
    parse_request,
)

_LEN = struct.Struct(">I")

# Reject absurd frames before allocating: a single 4-byte header would
# otherwise trigger an attempt at a ~4 GiB buffer in _recv_exact.
MAX_FRAME_BYTES = 64 * 1024 * 1024


def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _handle(conn: socket.socket, batcher: _MicroBatcher) -> None:
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        while True:
            head = _recv_exact(conn, _LEN.size)
            if head is None:
                return
            (length,) = _LEN.unpack(head)
            if length == 0:
                return
            if length > MAX_FRAME_BYTES:
                out = json.dumps({
                    "error": f"frame length {length} exceeds max "
                             f"{MAX_FRAME_BYTES}"}).encode()
                conn.sendall(_LEN.pack(len(out)) + out)
                return
            body = _recv_exact(conn, length)
            if body is None:
                return
            try:
                feats, binary = parse_request(body)
                probs = batcher.predict(feats)
                out = encode_response(probs, binary)
            except Exception as e:  # per-request error frame
                out = json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}
                ).encode()
            conn.sendall(_LEN.pack(len(out)) + out)
    finally:
        conn.close()


class SocketServer:
    """Accept loop + per-connection handler threads."""

    def __init__(self, servable: Servable, port: int,
                 batcher: _MicroBatcher | None = None):
        self.batcher = batcher or _MicroBatcher(servable)
        self.sock = socket.create_server(("127.0.0.1", port))
        self.port = self.sock.getsockname()[1]
        self._stop = False
        self.thread = threading.Thread(target=self._accept_loop, daemon=True)

    def start(self) -> None:
        self.thread.start()

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(
                target=_handle, args=(conn, self.batcher), daemon=True
            ).start()

    def shutdown(self) -> None:
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass


class SocketClient:
    """Persistent-connection client; prepared bodies via
    `client.prepare_body` time only the round trip (the reference also
    builds its Examples outside the clock, grpc_client.py:41-54)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.conn = socket.create_connection((host, port))
        self.conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send(self, body: bytes) -> np.ndarray:
        self.conn.sendall(_LEN.pack(len(body)) + body)
        head = _recv_exact(self.conn, _LEN.size)
        if head is None:
            raise ConnectionError("server closed connection")
        (length,) = _LEN.unpack(head)
        raw = _recv_exact(self.conn, length)
        if raw is None:
            raise ConnectionError("truncated response")
        from recsys.serve.client import _parse_response
        return _parse_response(raw)

    def predict(self, features: dict[str, np.ndarray]) -> np.ndarray:
        from recsys.serve.client import prepare_body
        return self.send(prepare_body(features, binary=True))

    def close(self) -> None:
        try:
            self.conn.sendall(_LEN.pack(0))
        except OSError:
            pass
        self.conn.close()
