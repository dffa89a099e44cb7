"""Serving: export → load → REST/gRPC round trip with AUC parity
(the grpc_client.py end-to-end check, SURVEY §3.2)."""

import threading

import jax
import numpy as np
import pytest

from recsys.core.config import CriteoConfig, ModelConfig
from recsys.data import criteo
from recsys.models.api import make_model
from recsys.serve import client as C
from recsys.serve.export import Servable, export_servable
from recsys.serve.server import make_grpc_server, make_rest_server

SMALL = CriteoConfig(cat_vocabs=tuple([50] * 26))
MCFG = ModelConfig(name="fm", embedding_dim=8)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("export"))
    model = make_model("fm", SMALL, MCFG)
    params, state = model.init(jax.random.key(0))
    export_servable(d, "fm", params, state, MCFG, SMALL)
    return d


def _features(n=16):
    data = criteo.synthetic_criteo(n, SMALL)
    labels = data.pop("label")
    return data, labels


def test_servable_predict_matches_direct(exported):
    sv = Servable(exported, buckets=(8, 32))
    feats, _ = _features(10)   # pads 10 → 32 bucket
    probs = sv.predict(feats)
    assert probs.shape == (10,)
    model = make_model("fm", SMALL, MCFG)
    params, state = model.init(jax.random.key(0))
    logits, _ = model.apply(params, state, feats, train=False)
    direct = np.asarray(jax.nn.sigmoid(logits))
    np.testing.assert_allclose(probs, direct, rtol=1e-5, atol=1e-6)


def test_rest_round_trip(exported):
    sv = Servable(exported, buckets=(8, 32))
    server, batcher = make_rest_server(sv, port=18512)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        feats, labels = _features(12)
        probs = C.rest_predict(18512, feats)
        assert probs.shape == (12,)
        stats = C.benchmark_serving(
            lambda f: C.rest_predict(18512, f), feats, labels,
            warmup=1, iters=3,
        )
        assert stats["latency_ms_mean"] > 0
        direct = sv.predict(feats)
        np.testing.assert_allclose(probs, direct, rtol=1e-4, atol=1e-5)
    finally:
        server.shutdown()
        batcher.stop()


def test_grpc_round_trip(exported):
    sv = Servable(exported, buckets=(8, 32))
    server, batcher = make_grpc_server(sv, port=18513)
    server.start()
    try:
        feats, _ = _features(9)
        probs = C.grpc_predict(18513, feats)
        assert probs.shape == (9,)
        direct = sv.predict(feats)
        np.testing.assert_allclose(probs, direct, rtol=1e-4, atol=1e-5)
    finally:
        server.stop(0)
        batcher.stop()


def test_microbatcher_coalesces(exported):
    sv = Servable(exported, buckets=(8, 64))
    from recsys.serve.server import _MicroBatcher
    mb = _MicroBatcher(sv, timeout_ms=20.0)
    feats, _ = _features(4)
    results = {}

    def call(i):
        results[i] = mb.predict(feats)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    direct = sv.predict(feats)
    for i in range(4):
        np.testing.assert_allclose(results[i], direct, rtol=1e-4, atol=1e-5)
    mb.stop()


def test_din_export_serve_round_trip(tmp_path):
    """Non-Criteo export/serve: DIN warms up from its meta-declared sample
    features and serves over REST (reference exports every estimator model,
    deepfm/deepfm.py:220-233)."""
    from recsys.models.din import make_din

    mcfg = ModelConfig(name="din", embedding_dim=8, use_bn=False,
                       attention_layers=(8, 4), mlp_layers=(16, 8, 4))
    model = make_din(item_vocab=500, cate_vocab=20, cfg=mcfg)
    params, state = model.init(jax.random.key(0))
    d = str(tmp_path / "din_export")
    export_servable(d, "din", params, state, mcfg,
                    factory_kwargs={"item_vocab": 500, "cate_vocab": 20})
    # Servable reconstructs via the registry factory with stored kwargs
    sv = Servable(d, buckets=(8, 32))
    sv.warmup()
    feats = model.meta["sample_features"](10)
    probs = sv.predict(feats)
    assert probs.shape == (10,)
    logits, _ = model.apply(params, state, feats, train=False)
    np.testing.assert_allclose(probs, np.asarray(jax.nn.sigmoid(logits)),
                               rtol=1e-4, atol=1e-5)

    server, batcher = make_rest_server(sv, port=18514)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        got = C.rest_predict(18514, feats)
        np.testing.assert_allclose(got, probs, rtol=1e-4, atol=1e-5)
    finally:
        server.shutdown()
        batcher.stop()


def test_binary_prepared_round_trip(exported):
    """NPZ1 columnar payloads over REST and gRPC match the JSON path."""
    sv = Servable(exported, buckets=(8, 32))
    rest, batcher = make_rest_server(sv, port=0)
    port = rest.server_address[1]
    t = threading.Thread(target=rest.serve_forever, daemon=True)
    t.start()
    grpc_srv, _ = make_grpc_server(sv, port + 1, batcher)
    grpc_srv.start()
    try:
        feats, _ = _features(11)
        body = C.prepare_body(feats, binary=True)
        via_rest = C.rest_send(port, body)
        stub = C.make_grpc_stub(port + 1)
        via_grpc = C.grpc_send(stub, body)
        direct = sv.predict(feats)
        np.testing.assert_allclose(via_rest, direct, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(via_grpc, direct, rtol=1e-4, atol=1e-5)
        # JSON prepared body goes through the same send path
        np.testing.assert_allclose(
            C.rest_send(port, C.prepare_body(feats)), direct,
            rtol=1e-4, atol=1e-5)
    finally:
        rest.shutdown()
        grpc_srv.stop(0)
        batcher.stop()


def test_socket_round_trip(exported):
    from recsys.serve.fastsock import SocketClient, SocketServer

    sv = Servable(exported, buckets=(8, 32))
    srv = SocketServer(sv, port=0)
    srv.start()
    try:
        feats, _ = _features(12)
        sc = SocketClient(srv.port)
        probs = sc.predict(feats)
        assert probs.shape == (12,)
        # matches the direct servable path exactly
        np.testing.assert_allclose(probs, sv.predict(feats),
                                   rtol=1e-6, atol=1e-7)
        # JSON body works over the same wire
        probs_json = sc.send(C.prepare_body(feats, binary=False))
        np.testing.assert_allclose(probs_json, probs, rtol=1e-5, atol=1e-6)
        # error frame surfaces as an exception, connection stays usable
        with pytest.raises(RuntimeError):
            sc.send(b'{"instances": [{"bogus": 1}]}')
        np.testing.assert_allclose(sc.predict(feats), probs,
                                   rtol=1e-6, atol=1e-7)
        sc.close()
    finally:
        srv.shutdown()


def test_socket_rejects_oversized_frame(exported):
    import socket as socket_mod
    import struct

    from recsys.serve import fastsock
    from recsys.serve.fastsock import SocketServer

    sv = Servable(exported, buckets=(8, 32))
    srv = SocketServer(sv, port=0)
    srv.start()
    try:
        conn = socket_mod.create_connection(("127.0.0.1", srv.port))
        # a lone 4-byte header claiming a ~4 GiB body must get an error
        # frame back (no allocation), then the server closes the connection
        conn.sendall(struct.pack(">I", fastsock.MAX_FRAME_BYTES + 1))
        head = conn.recv(4)
        (length,) = struct.unpack(">I", head)
        body = b""
        while len(body) < length:
            chunk = conn.recv(length - len(body))
            if not chunk:
                break
            body += chunk
        assert b"exceeds max" in body
        conn.close()
    finally:
        srv.shutdown()


def test_raw_wire_format_round_trip():
    from recsys.serve.server import encode_raw, parse_raw, parse_request

    feats = {
        "ids": np.arange(78, dtype=np.int32).reshape(2, 39),
        "dense": np.linspace(0, 1, 26, dtype=np.float32).reshape(2, 13),
    }
    body = encode_raw(feats)
    out = parse_raw(body)
    assert set(out) == {"ids", "dense"}
    np.testing.assert_array_equal(out["ids"], feats["ids"])
    np.testing.assert_array_equal(out["dense"], feats["dense"])
    parsed, fmt = parse_request(body)
    assert fmt == "raw"
    np.testing.assert_array_equal(parsed["ids"], feats["ids"])


def test_socket_raw_round_trip(exported):
    from recsys.serve.fastsock import SocketClient, SocketServer

    sv = Servable(exported, buckets=(8, 32))
    srv = SocketServer(sv, port=0)
    srv.start()
    try:
        feats, _ = _features(12)
        sc = SocketClient(srv.port)
        probs_raw = sc.send(C.prepare_body(feats, fmt="raw"))
        np.testing.assert_allclose(probs_raw, sv.predict(feats),
                                   rtol=1e-6, atol=1e-7)
        sc.close()
    finally:
        srv.shutdown()


def test_grpc_async_pipelined(exported):
    """Future-based async predicts (stub.Predict.future parity,
    deepfm/grpc_client.py:80): N in-flight requests on one channel all
    resolve to the direct servable results."""
    from recsys.serve.server import make_grpc_server

    sv = Servable(exported, buckets=(8, 32))
    server, batcher = make_grpc_server(sv, port=18517)
    server.start()
    try:
        stub = C.make_grpc_stub(18517)
        batches = [_features(8)[0] for _ in range(6)]
        bodies = [C.prepare_body(f, fmt="raw") for f in batches]
        # fire one future explicitly, then the pipelined helper
        fut = C.grpc_send_future(stub, bodies[0])
        np.testing.assert_allclose(
            C.grpc_future_result(fut), sv.predict(batches[0]),
            rtol=1e-5, atol=1e-6)
        outs = C.grpc_predict_pipelined(stub, bodies)
        assert len(outs) == 6
        for feats, probs in zip(batches, outs):
            np.testing.assert_allclose(probs, sv.predict(feats),
                                       rtol=1e-5, atol=1e-6)
    finally:
        server.stop(0)
        batcher.stop()


@pytest.mark.parametrize("have_grpc", [True, False])
def test_start_servers_with_and_without_grpc(exported, monkeypatch,
                                             have_grpc):
    """All front-ends come up on one micro-batcher; without grpcio the
    gRPC endpoint is left out and REST + socket still answer."""
    import sys

    from recsys.serve.fastsock import SocketClient
    from recsys.serve.server import start_servers

    if not have_grpc:
        monkeypatch.setitem(sys.modules, "grpc", None)   # import fails
    sv = Servable(exported, buckets=(8, 32))
    endpoints, stop = start_servers(sv, 0)
    try:
        assert ("gRPC" in endpoints) == have_grpc
        assert endpoints["socket"] == endpoints["REST"] + 2
        feats, _ = _features(12)
        direct = sv.predict(feats)
        np.testing.assert_allclose(C.rest_predict(endpoints["REST"], feats),
                                   direct, rtol=1e-5, atol=1e-6)
        sc = SocketClient(endpoints["socket"])
        np.testing.assert_allclose(sc.predict(feats), direct,
                                   rtol=1e-6, atol=1e-7)
        sc.close()
        if have_grpc:
            np.testing.assert_allclose(
                C.grpc_predict(endpoints["gRPC"], feats), direct,
                rtol=1e-5, atol=1e-6)
    finally:
        stop()
