"""The port's SearchService on the CPU: submit(), /search and /search_raw
answer what FusedScanIndex.search answers; the raw wire format is
byte-identical to the JAX package's; stop() joins its threads."""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from gbnns_tpu import serve as jax_serve
from gbnns_tpu_torch import cli
from gbnns_tpu_torch import serve as port_serve
from gbnns_tpu_torch.io.vecs import write_fvecs
from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex
from gbnns_tpu_torch.serve import (SearchService, make_server,
                                   pack_raw_request, serve,
                                   unpack_raw_response)


@pytest.fixture(scope="module")
def running(fixture_data):
    base, _ = fixture_data
    svc = SearchService(base, engine="fused", c=16, max_wait_ms=1.0,
                        device="cpu")
    httpd = make_server(svc, 0, "127.0.0.1")
    t = threading.Thread(target=serve, args=(svc,), kwargs={"httpd": httpd})
    t.start()
    yield svc, httpd.server_address[1]
    httpd.shutdown()
    t.join(10)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def direct(fixture_data):
    base, query = fixture_data
    ids, dists = FusedScanIndex(base, device="cpu").search(query, k=10, c=16)
    return ids.numpy(), dists.numpy()


def _request(port, method, path, body=None, ctype="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_submit_equals_index_search(running, fixture_data, direct):
    svc, _ = running
    _, query = fixture_data
    results = {}

    def ask(lo, hi):
        results[lo] = svc.submit(query[lo:hi], None, 10)

    spans = [(0, 1), (1, 9), (9, 40), (40, 128)]
    threads = [threading.Thread(target=ask, args=s) for s in spans]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    for lo, hi in spans:
        ids, dists = results[lo]
        np.testing.assert_array_equal(ids, direct[0][lo:hi])
        np.testing.assert_allclose(dists, direct[1][lo:hi], rtol=1e-6)


def test_submit_smaller_k(running, fixture_data, direct):
    svc, _ = running
    ids, dists = svc.submit(fixture_data[1][:5], None, 3)
    assert ids.shape == (5, 3)
    np.testing.assert_array_equal(ids, direct[0][:5, :3])


def test_search_json(running, fixture_data, direct):
    _, port = running
    _, query = fixture_data
    status, body = _request(port, "POST", "/search", json.dumps(
        {"queries": query[:4].tolist(), "k": 10}).encode())
    assert status == 200
    obj = json.loads(body)
    np.testing.assert_array_equal(np.asarray(obj["ids"]), direct[0][:4])
    assert obj["took_ms"] >= 0


def test_search_raw(running, fixture_data, direct):
    _, port = running
    _, query = fixture_data
    status, body = _request(port, "POST", "/search_raw",
                            pack_raw_request(query[10:30], 10),
                            "application/octet-stream")
    assert status == 200
    ids, dists = unpack_raw_response(body)
    np.testing.assert_array_equal(ids, direct[0][10:30])
    np.testing.assert_allclose(dists, direct[1][10:30], rtol=1e-6)


@pytest.mark.parametrize("body", [b"short", np.zeros(4, "<i4").tobytes(),
                                  jax_serve.pack_raw_request(
                                      np.zeros((2, 5), np.float32), 3)])
def test_search_raw_rejects_malformed(running, body):
    _, port = running
    status, _ = _request(port, "POST", "/search_raw", body,
                         "application/octet-stream")
    assert status == 400


def test_healthz_and_404(running):
    _, port = running
    status, body = _request(port, "GET", "/healthz")
    assert status == 200 and json.loads(body)["engine"] == "fused"
    assert _request(port, "GET", "/nope")[0] == 404
    assert _request(port, "POST", "/nope", b"{}")[0] == 404
    assert _request(port, "POST", "/search", b'{"queries": []}')[0] == 400


def test_raw_wire_bytes_match_jax():
    q = np.random.default_rng(3).normal(size=(7, 5)).astype(np.float32)
    assert pack_raw_request(q, 4) == jax_serve.pack_raw_request(q, 4)
    ids = np.arange(12, dtype="<i4").reshape(3, 4)
    dists = np.linspace(0, 1, 12, dtype="<f4").reshape(3, 4)
    body = (np.array([3, 4], "<i4").tobytes() + ids.tobytes()
            + dists.tobytes())
    for a, b in zip(unpack_raw_response(body),
                    jax_serve.unpack_raw_response(body)):
        np.testing.assert_array_equal(a, b)
    assert port_serve.RAW_MAGIC == jax_serve.RAW_MAGIC


def test_stop_joins_threads_quickly(fixture_data):
    base, query = fixture_data
    svc = SearchService(base, engine="flat", device="cpu")
    assert svc.submit(query[:2], None, 5)[0].shape == (2, 5)
    t0 = time.perf_counter()
    svc.stop()
    assert time.perf_counter() - t0 < 5.0
    assert not svc._dispatcher.is_alive()
    assert not svc._completer.is_alive()
    svc.stop()   # idempotent
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit(query[:2], None, 5)


class _Poison:
    """A queue item whose every attribute read raises: a dispatcher fault."""

    def __getattr__(self, name):
        raise RuntimeError("dispatcher fault")


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_stop_after_dispatcher_failure(fixture_data):
    base, _ = fixture_data
    svc = SearchService(base, engine="flat", device="cpu")
    svc._q.put(_Poison())       # the dispatcher thread dies on it
    svc._dispatcher.join(5)
    assert not svc._dispatcher.is_alive()
    t0 = time.perf_counter()
    svc.stop()                  # the completer still ends
    assert time.perf_counter() - t0 < 5.0
    assert not svc._completer.is_alive()


def test_dispatch_errors_reach_the_caller(fixture_data):
    base, query = fixture_data
    svc = SearchService(base, engine="flat", device="cpu")
    try:
        with pytest.raises(RuntimeError, match="shapes"):
            svc.submit(query[:2, :5], None, 5)   # wrong query width
        assert svc.submit(query[:2], None, 5)[0].shape == (2, 5)
    finally:
        svc.stop()


def test_graph_engines_are_not_ported(fixture_data):
    base, _ = fixture_data
    for kw in (dict(engine="graph"), dict(engine="graph_pallas"),
               dict(graph=np.zeros((2048, 4), np.int32))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SearchService(base, device="cpu", **kw)


def test_h2d_bfloat16_and_projection(fixture_data):
    import torch

    base, query = fixture_data
    w = torch.from_numpy(
        np.random.default_rng(4).normal(size=(32, 16)).astype(np.float32))
    svc = SearchService(base, (base @ w.numpy()), engine="fused", c=16,
                        projection=lambda q: q @ w, h2d_dtype="bfloat16",
                        device="cpu")
    try:
        ids, _ = svc.submit(query[:8], None, 10)
        qb = torch.from_numpy(query[:8]).to(torch.bfloat16).float()
        ref, _ = svc.fused.search(qb, qb @ w, k=10, c=16)
        np.testing.assert_array_equal(ids, ref.numpy())
    finally:
        svc.stop()


def test_cli_builds_the_service(tmp_path, fixture_data):
    base, _ = fixture_data
    write_fvecs(str(tmp_path / "base.fvecs"), base)
    args = ["serve", "--base", str(tmp_path / "base.fvecs"), "--engine",
            "fused", "--c", "16", "--device", "cpu"]
    parser_args = _parse(args)
    svc = cli.build_service(parser_args)
    try:
        assert svc.engine == "fused" and svc.fused is not None
        assert svc.warm(k=10) == 5
    finally:
        svc.stop()
    with pytest.raises(NotImplementedError):
        cli.build_service(_parse(args + ["--graph", "g.npy"]))
    with pytest.raises(SystemExit):
        _parse(["serve", "--engine", "graph"])


def _parse(argv):
    captured = {}

    def grab(ns):
        captured["ns"] = ns

    import argparse

    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        ns = real(self, args, namespace)
        ns.fn = grab
        return ns

    argparse.ArgumentParser.parse_args = parse
    try:
        cli.main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["ns"]
