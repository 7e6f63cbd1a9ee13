"""The graph serving path: sizing, GraphIndex, both graph engines of
SearchService (submit and HTTP) and the ``build`` and ``serve --graph
--centroids`` commands, on the CPU, against the JAX package where it has a
counterpart. Small corpus: n = 2,048, d = 24, K = 12.

Tolerances: sizing is equal byte for byte; ``GraphIndex.from_jax(...)
.search`` is within 0.005 of JAX's ``GraphIndex.search`` in recall@10; a
served answer equals the direct search of the same queries exactly (a walk
is per query, so the batch it rides in cannot change it); against the JAX
package's ``SearchService`` on the same corpus, graph and staged centroids,
engine "graph" answers with equal ids on at least 98 % of rows and engine
"graph_pallas" within 0.005 in recall@10."""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from gbnns_tpu.search import sizing as jax_sizing
from gbnns_tpu.search.graph_index import GraphIndex as JaxGraphIndex
from gbnns_tpu.serve import SearchService as JaxSearchService
from gbnns_tpu_torch import cli
from gbnns_tpu_torch.build.knn_graph import (build_knn_graph, load_graph,
                                             save_graph)
from gbnns_tpu_torch.eval.recall import recall_at_k
from gbnns_tpu_torch.io.synthetic import SyntheticSpec, make_synthetic
from gbnns_tpu_torch.io.vecs import write_fvecs
from gbnns_tpu_torch.kernels.topk import knn
from gbnns_tpu_torch.search import sizing
from gbnns_tpu_torch.search.entries import CentroidEntries
from gbnns_tpu_torch.search.graph_index import GraphIndex
from gbnns_tpu_torch.search.rerank import rerank
from gbnns_tpu_torch.search.walker import beam_search
from gbnns_tpu_torch.serve import (SearchService, make_server,
                                   pack_raw_request, serve,
                                   unpack_raw_response)


@pytest.fixture(scope="module")
def corpus():
    data = make_synthetic(SyntheticSpec(n_base=2048, n_query=64, dim=24,
                                        n_clusters=16, seed=11))
    base, query = data["base"], data["query"]
    graph = build_knn_graph(base, 12, chunk=1024, node_chunk=1024,
                            device="cpu")
    gt = knn(query, base, 10, device="cpu")[1].numpy()
    return base, query, graph, gt


@pytest.mark.parametrize("n,d,d_lo,K,vec_dtype,rr", [
    (1_000_000, 128, 32, 32, "bfloat16", 4),
    (1_000_000, 960, 128, 32, "bfloat16", 2),
    (2048, 24, 24, 12, "float32", 4),
])
def test_sizing_matches_jax(n, d, d_lo, K, vec_dtype, rr):
    mine = sizing.graph_index_hbm(n, d, d_lo, K, vec_dtype=vec_dtype,
                                  rerank_itemsize=rr, row_words=1024)
    ref = jax_sizing.graph_index_hbm(n, d, d_lo, K, vec_dtype=vec_dtype,
                                     rerank_itemsize=rr)
    for field in ("payload_bytes", "reduced_bytes", "rerank_bytes",
                  "graph_bytes", "norms_bytes", "total_bytes"):
        assert getattr(mine, field) == getattr(ref, field), field
    fm = sizing.fused_index_hbm(n, d, d_lo, rerank_itemsize=rr)
    fr = jax_sizing.fused_index_hbm(n, d, d_lo, rerank_itemsize=rr)
    assert fm.total_bytes == fr.total_bytes
    # the port's own rows: 128-byte lines instead of 4 KB tiles
    assert sizing.payload_row_bytes(32, 32) == 2176
    assert jax_sizing.payload_row_bytes(32, 32) == 4096


def test_sizing_equals_the_packed_payload(corpus):
    base, _, graph, _ = corpus
    for vec_dtype in ("bfloat16", "float32"):
        idx = GraphIndex.build(base, K=12, ncent=None, graph=graph,
                               vec_dtype=vec_dtype, device="cpu")
        sz = sizing.graph_index_hbm(2048, 24, 24, 12, vec_dtype=vec_dtype)
        assert idx.stats["payload_bytes"] == sz.payload_bytes \
            == idx.payload.data.numel() * 4
        assert idx.stats["est_hbm_bytes"] == sz.total_bytes
    with pytest.raises(MemoryError, match="exceeds budget"):
        GraphIndex.build(base, K=12, ncent=None, hbm_budget=1024.0,
                         device="cpu")
    with pytest.raises(ValueError, match="K\\*d_lo even"):
        GraphIndex.build(base[:, :15], K=3, ncent=None, device="cpu")


def test_graph_index_from_jax_matches_jax(corpus):
    base, query, graph, gt = corpus
    ref_idx = JaxGraphIndex.build(base, K=12, ncent=32, graph=graph)
    ref = np.asarray(ref_idx.search(query, k=10, ef=32)[0])
    mine = GraphIndex.from_jax(ref_idx, device="cpu")
    assert mine.payload.bf16 and mine.payload.words == 160
    ids, dists = mine.search(query, k=10, ef=32)
    assert ids.dtype == torch.int32 and dists.shape == (64, 10)
    r_mine, r_ref = recall_at_k(ids.numpy(), gt, 10), recall_at_k(ref, gt, 10)
    assert abs(r_mine - r_ref) <= 0.005 and r_mine > 0.9


def test_graph_index_builds_on_its_own(corpus):
    base, query, _, gt = corpus
    idx = GraphIndex.build(base, K=12, ncent=32, device="cpu",
                           build_kwargs=dict(chunk=1024, node_chunk=1024))
    assert idx.graph.shape == (2048, 12) and idx.entries is not None
    assert recall_at_k(idx.search(query, k=10, ef=32)[0].numpy(), gt,
                       10) > 0.9
    strided = GraphIndex.build(base, K=12, ncent=None, graph=idx.graph,
                               device="cpu")
    assert recall_at_k(strided.search(query, k=10, ef=32)[0].numpy(), gt,
                       10) > 0.85


def _post(port, path, body, ctype):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        assert resp.status == 200
        return resp.read()
    finally:
        conn.close()


def _direct(svc, query):
    q = torch.from_numpy(query)
    if svc.engine == "graph_pallas":
        return svc.gidx.search(q, k=10, ef=32, num_entries=16)[0].numpy()
    res = beam_search(q, svc.base_lo_f32, svc.graph, svc.entries, ef=32)
    return rerank(q, svc.flat.base_full, res.ids, 10)[0].numpy()


@pytest.mark.parametrize("engine", ["graph_pallas", "graph"])
def test_graph_engines_over_http(corpus, tmp_path, engine):
    base, query, graph, gt = corpus
    cents = str(tmp_path / "cents.npz")
    CentroidEntries.build(base, ncent=16, iters=2, device="cpu").save(cents)
    svc = SearchService(base, graph=graph, engine=engine, ef=32,
                        centroids_path=cents if engine == "graph_pallas"
                        else None, max_wait_ms=1.0, device="cpu")
    if engine == "graph_pallas":
        assert svc.gidx.entries.centroids.shape == (16, 24)  # loaded
    httpd = make_server(svc, 0, "127.0.0.1")
    port = httpd.server_address[1]
    server = threading.Thread(target=serve, args=(svc,),
                              kwargs={"httpd": httpd})
    server.start()
    try:
        direct = _direct(svc, query)
        ids, _ = svc.submit(query, None, 10)
        np.testing.assert_array_equal(ids, direct)
        assert recall_at_k(ids, gt, 10) > 0.85
        ids, dists = unpack_raw_response(_post(
            port, "/search_raw", pack_raw_request(query[:20], 10),
            "application/octet-stream"))
        np.testing.assert_array_equal(ids, direct[:20])
        assert np.isfinite(dists).all()
        js = json.loads(_post(port, "/search", json.dumps(
            {"queries": query[:2].tolist(), "k": 5}).encode(),
            "application/json"))
        np.testing.assert_array_equal(np.asarray(js["ids"]), direct[:2, :5])
    finally:
        httpd.shutdown()
        server.join(30)
    assert not server.is_alive()
    assert not svc._dispatcher.is_alive()


@pytest.mark.parametrize("engine", ["graph", "graph_pallas"])
def test_graph_engines_match_the_jax_service(corpus, tmp_path, engine):
    """Both packages' services on one corpus, graph and centroids file (the
    port's, which the JAX package loads): the engine's own wiring (strided
    entries min(32, ef), the centroid count, num_entries = min(16, ef))
    must be the same."""
    base, query, graph, gt = corpus
    cents = str(tmp_path / "cents.npz")
    if engine == "graph_pallas":
        CentroidEntries.build(base, ncent=16, iters=2, device="cpu") \
            .save(cents)
    kw = dict(graph=graph, engine=engine, ef=32, max_wait_ms=1.0,
              centroids_path=cents if engine == "graph_pallas" else None)
    mine_svc = SearchService(base, device="cpu", **kw)
    ref_svc = JaxSearchService(base, **kw)
    try:
        mine, _ = mine_svc.submit(query, None, 10)
        ref, _ = ref_svc.submit(query, None, 10)
    finally:
        mine_svc.stop()
        ref_svc.stop()
    ref = np.asarray(ref)
    if engine == "graph":
        assert (mine == ref).all(axis=1).mean() >= 0.98
    else:
        assert abs(recall_at_k(mine, gt, 10) - recall_at_k(ref, gt, 10)) \
            <= 0.005
    assert recall_at_k(mine, gt, 10) > 0.85


def test_graph_engines_need_a_graph(corpus):
    base = corpus[0]
    for engine in ("graph", "graph_pallas"):
        with pytest.raises(ValueError, match="requires a graph"):
            SearchService(base, engine=engine, device="cpu")


def test_cli_serve_with_graph_and_centroids(corpus, tmp_path):
    base, query, graph, _ = corpus
    write_fvecs(str(tmp_path / "base.fvecs"), base)
    save_graph(str(tmp_path / "graph.npy"), graph)
    ce = CentroidEntries.build(base, ncent=16, iters=2, device="cpu")
    ce.save(str(tmp_path / "cents.npz"))
    common = ["serve", "--base", str(tmp_path / "base.fvecs"), "--graph",
              str(tmp_path / "graph.npy"), "--ef", "32", "--device", "cpu"]
    for extra in (["--engine", "graph_pallas", "--centroids",
                   str(tmp_path / "cents.npz")], ["--engine", "graph"]):
        svc = cli.build_service(cli.make_parser().parse_args(common + extra))
        try:
            assert svc.engine == extra[1]
            if svc.engine == "graph_pallas":
                assert torch.equal(svc.gidx.entries.node_ids, ce.node_ids)
            ids, _ = svc.submit(query[:8], None, 10)
            np.testing.assert_array_equal(ids, _direct(svc, query[:8]))
        finally:
            svc.stop()


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_cli_build(corpus, tmp_path, backend):
    base = corpus[0]
    write_fvecs(str(tmp_path / "base.fvecs"), base)
    out = str(tmp_path / "graph.npy")
    cli.main(["build", "--base", str(tmp_path / "base.fvecs"), "--k", "8",
              "--backend", backend, "--node-chunk", "1024", "--out", out,
              "--device", "cpu"])
    want = build_knn_graph(base, 8, backend=backend, node_chunk=1024,
                           device="cpu")
    np.testing.assert_array_equal(load_graph(out), want)
