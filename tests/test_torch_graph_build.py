"""The graph build, k-means and centroid entries: the port (on the CPU,
through the plain versions of kernels K1 and K2) against the JAX package, on
the small corpus of tests/test_walker_pallas.py (n = 2,048, d = 24, K = 12).

Tolerances: the numpy host passes, given the same input graph, are equal;
the exact build equals JAX's except where two candidates tie to 1e-5; the
fused build's candidate sets are equal on ≥ 99 % of rows (its bf16 scores
are quantized by the merge's packed keys); Lloyd's iterations from the same
initial centroids agree to 1e-5 and the assignment is equal; a
``CentroidEntries`` file saved by one package gives equal ``query_entries``
in the other."""

import numpy as np
import pytest
import torch

from gbnns_tpu.build import kmeans as jax_km
from gbnns_tpu.build import knn_graph as jax_kg
from gbnns_tpu.io.synthetic import SyntheticSpec, make_synthetic
from gbnns_tpu.search.entries import CentroidEntries as JaxEntries
from gbnns_tpu_torch.build import kmeans as km
from gbnns_tpu_torch.build import knn_graph as kg
from gbnns_tpu_torch.search.entries import CentroidEntries, entries_from_jax
from gbnns_tpu_torch.search.walker import default_entry_ids


@pytest.fixture(scope="module")
def corpus():
    data = make_synthetic(SyntheticSpec(n_base=2048, n_query=64, dim=24,
                                        n_clusters=16, seed=11))
    return data["base"], data["query"]


def _random_graph(n, K, seed, holes=0.0):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n, size=(n, K)).astype(np.int32)
    g[rng.random((n, K)) < holes] = -1
    return g


def test_drop_self_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 500, size=(200, 9)).astype(np.int32)
    rows = rng.random(200) < 0.7
    cols = rng.integers(0, 9, 200)
    ids[rows, cols[rows]] = np.arange(300, 500)[rows]
    np.testing.assert_array_equal(kg._drop_self(ids, 300),
                                  jax_kg._drop_self(ids, 300))


@pytest.mark.parametrize("frac", [0.5, 0.25, 0.0])
def test_add_reverse_edges_matches_jax(frac):
    g = _random_graph(1000, 12, 1, holes=0.05)
    np.testing.assert_array_equal(kg.add_reverse_edges(g, frac),
                                  jax_kg.add_reverse_edges(g, frac))


def test_reachability_and_components_match_jax():
    # ten blocks of 100 nodes, edges inside a block only, some holes
    rng = np.random.default_rng(2)
    n = 1000
    g = ((np.arange(n)[:, None] // 100) * 100
         + rng.integers(0, 100, size=(n, 6))).astype(np.int32)
    g[rng.random(g.shape) < 0.1] = -1
    for entries in ([0, 150], [5], list(range(0, 1000, 100))):
        np.testing.assert_array_equal(kg.forward_reachable(g, entries),
                                      jax_kg.forward_reachable(g, entries))
    np.testing.assert_array_equal(kg.connected_components(g),
                                  jax_kg.connected_components(g))


def test_ensure_connected_matches_jax(corpus):
    base, _ = corpus
    raw = jax_kg.build_knn_graph(base, 12, chunk=1024, node_chunk=1024,
                                 connect=False, reverse_frac=0.0)
    entries = np.asarray(default_entry_ids(base.shape[0]))
    assert not kg.forward_reachable(raw, entries).all()   # work to do
    mine = kg.ensure_connected(base, raw)
    np.testing.assert_array_equal(mine, jax_kg.ensure_connected(base, raw))
    assert kg.forward_reachable(mine, entries).all()


def test_exact_build_matches_jax(corpus):
    base, _ = corpus
    kw = dict(chunk=1024, node_chunk=1024)
    ref = jax_kg.build_knn_graph(base, 12, connect=False, reverse_frac=0.0,
                                 **kw)
    mine = kg.build_knn_graph(base, 12, connect=False, reverse_frac=0.0,
                              device="cpu", **kw)
    assert mine.shape == ref.shape and mine.dtype == np.int32
    for r in np.nonzero((mine != ref).any(axis=1))[0]:   # ties only
        dm = ((base[mine[r]] - base[r]) ** 2).sum(-1)
        dr = ((base[ref[r]] - base[r]) ** 2).sum(-1)
        np.testing.assert_allclose(dm, dr, rtol=1e-5, atol=1e-5)
    stats = {}
    full = kg.build_knn_graph(base, 12, device="cpu", stats=stats, **kw)
    full_ref = jax_kg.build_knn_graph(base, 12, **kw)
    assert (full == full_ref).all(axis=1).mean() >= 0.99
    assert set(stats) == {"scan_s", "reverse_s", "connect_s"}


def test_fused_build_candidates_match_jax(corpus):
    base, _ = corpus
    ref = jax_kg._build_fused(base, 12, metric="l2", node_chunk=1024)
    mine = kg._build_fused(base, 12, metric="l2", node_chunk=1024,
                           device="cpu")
    assert mine.shape == ref.shape == (2048, 13)
    same = np.mean([set(a) == set(b) for a, b in zip(mine, ref)])
    assert same >= 0.99
    graph = kg.build_knn_graph(base, 12, backend="fused", node_chunk=1024,
                               device="cpu")
    assert graph.shape == (2048, 12)
    assert kg.forward_reachable(graph, default_entry_ids(2048)).all()


def test_backend_refusals_match_jax(corpus):
    base, _ = corpus
    for build in (jax_kg.build_knn_graph, kg.build_knn_graph):
        with pytest.raises(ValueError, match="demoted in round 4"):
            build(base, 12, backend="pallas")
        with pytest.raises(ValueError, match="unknown backend"):
            build(base, 12, backend="faiss")


def test_save_and_load_graph_interoperate(tmp_path):
    g = _random_graph(50, 4, 3)
    kg.save_graph(str(tmp_path / "port.npy"), g)
    np.testing.assert_array_equal(jax_kg.load_graph(str(tmp_path / "port.npy")),
                                  g)
    jax_kg.save_graph(str(tmp_path / "jax.npy"), g)
    np.testing.assert_array_equal(kg.load_graph(str(tmp_path / "jax.npy")), g)
    np.save(tmp_path / "bad.npy", g.astype(np.int64))
    with pytest.raises(ValueError):
        kg.load_graph(str(tmp_path / "bad.npy"))


def test_lloyd_matches_jax_from_the_same_start(corpus):
    base, _ = corpus
    ncent, seed = 32, 3
    init = base[np.random.default_rng(seed).choice(base.shape[0], ncent,
                                                   replace=False)]
    ref = jax_km.kmeans_fit(base, ncent, iters=5, seed=seed, sample=None)
    mine = km.kmeans_fit(base, ncent, iters=5, sample=None, init=init,
                         device="cpu")
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(km.kmeans_assign(base, ref, chunk=500,
                                                   device="cpu"),
                                  jax_km.kmeans_assign(base, ref))


def test_kmeans_draws_from_its_seed(corpus):
    base, _ = corpus
    a = km.kmeans_fit(base, 16, iters=2, seed=1, sample=1000, device="cpu")
    b = km.kmeans_fit(base, 16, iters=2, seed=1, sample=1000, device="cpu")
    c = km.kmeans_fit(base, 16, iters=2, seed=2, sample=1000, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError):
        km.kmeans_fit(base[:8], 16, device="cpu")
    with pytest.raises(ValueError):
        km.kmeans_fit(base, 16, init=base[:4], device="cpu")


def test_centroid_entries_files_load_in_either_package(corpus, tmp_path):
    base, query = corpus
    ref = JaxEntries.build(base, ncent=32, iters=4)
    ref.save(str(tmp_path / "jax.npz"))
    loaded = CentroidEntries.load(str(tmp_path / "jax.npz"), device="cpu")
    want = np.asarray(ref.query_entries(query, 8))
    np.testing.assert_array_equal(loaded.query_entries(query, 8).numpy(), want)
    np.testing.assert_array_equal(
        entries_from_jax(ref, device="cpu").query_entries(query, 8).numpy(),
        want)

    mine = CentroidEntries.build(base, ncent=32, iters=4, device="cpu")
    assert mine.node_ids.dtype == torch.int32
    mine.save(str(tmp_path / "port.npz"))
    theirs = JaxEntries.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(
        np.asarray(theirs.query_entries(query, 8)),
        mine.query_entries(query, 8).numpy())
    # each representative is its centroid's nearest corpus row
    cents = mine.centroids.numpy()
    d = ((cents[:, None, :] - base[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(mine.node_ids.numpy(), d.argmin(axis=1))
