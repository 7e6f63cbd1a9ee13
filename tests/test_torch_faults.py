"""Repaired faults of the port, each held against the JAX package on the CPU:

* exact top-k keeps the lower index on ties, as ``lax.top_k`` does (exact
  kNN, ground truth, the flat index, the centroid entries);
* k-means draws its sample and its start as the JAX package does, so one
  seed gives the same centroids;
* the fused scan takes float16, as the JAX one does;
* the port's entry points take the JAX package's keywords (``tq``;
  ``exact``, ``recall_target``, ``dtype``, ``precision``), so code written
  for the JAX package runs on the port.

Inputs come from numpy with a seed; JAX runs on the CPU (the Pallas scan in
interpret mode)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.build import kmeans as jax_km
from gbnns_tpu.build import knn_graph as jax_kg
from gbnns_tpu.eval.recall import exact_ground_truth as jax_gt
from gbnns_tpu.kernels.scan_topk_pallas import FusedScanIndex as JaxFused
from gbnns_tpu.kernels.topk import knn as jax_knn
from gbnns_tpu.search.entries import CentroidEntries as JaxEntries
from gbnns_tpu.search.flat import FlatIndex as JaxFlat
from gbnns_tpu_torch.build import kmeans as km
from gbnns_tpu_torch.build import knn_graph as kg
from gbnns_tpu_torch.eval.recall import exact_ground_truth, recall_at_k
from gbnns_tpu_torch.kernels import scan_topk as st
from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex
from gbnns_tpu_torch.kernels.topk import knn, knn_chunked, knn_fused, smallest_k
from gbnns_tpu_torch.search.entries import entries_from_jax
from gbnns_tpu_torch.search.flat import FlatIndex


@pytest.fixture(scope="module")
def duplicated():
    """3,000 random 16-d rows, each stored four times at shuffled positions,
    and 256 queries: every neighbour has three exact ties."""
    rng = np.random.default_rng(21)
    rows = rng.normal(size=(3000, 16)).astype(np.float32)
    base = np.tile(rows, (4, 1))[rng.permutation(12000)]
    query = rng.normal(size=(256, 16)).astype(np.float32)
    return base, query


def test_smallest_k_keeps_the_lower_column():
    d = torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0, 2.0],
                      [-1.0, -0.0, 0.0, -2.0, 3.0, -2.0]])
    vals, cols = smallest_k(d, 3)
    assert cols.tolist() == [[1, 2, 3], [3, 5, 0]]
    assert vals.tolist() == [[0.0, 0.0, 0.0], [-2.0, -2.0, -1.0]]


@pytest.mark.parametrize("k", [1, 7, 33, 500])
def test_smallest_k_is_a_stable_sort_prefix(k):
    """Rows without ties, with ties inside the selection and with ties
    across its boundary: the first k columns of a stable argsort."""
    rng = np.random.default_rng(k)
    d = np.concatenate([rng.normal(size=(100, 500)),
                        rng.integers(0, 20, size=(100, 500)),
                        rng.integers(0, 400, size=(100, 500))]).astype(
                            np.float32)
    vals, cols = smallest_k(torch.from_numpy(d), k)
    want = np.argsort(d, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(cols.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(d, want, 1))


@pytest.mark.parametrize("k", [3, 10])
def test_exact_knn_ties_match_jax(duplicated, k):
    base, query = duplicated
    ref = np.asarray(jax_knn(query, base, k)[1])
    # a chunk that splits the corpus, so ties also meet across chunks
    mine = knn(query, base, k, chunk=5000, device="cpu")[1].numpy()
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(
        exact_ground_truth(query, base, k=k, device="cpu"),
        jax_gt(query, base, k=k))


@pytest.mark.parametrize("k", [3, 10])
def test_flat_index_ties_match_jax(duplicated, k):
    base, query = duplicated
    ref = JaxFlat(base).search(query, k=k, c=2 * k)[0]
    mine = FlatIndex(base, device="cpu").search(query, k=k, c=2 * k)[0]
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("E", [3, 10])
def test_centroid_entries_ties_match_jax(duplicated, E):
    """Centroids stored four times: each query's nearest ones all tie."""
    base, query = duplicated
    ref = JaxEntries.build(base, ncent=16, iters=2)
    ref.centroids = jnp.tile(ref.centroids, (4, 1))
    ref.cent_sq = jnp.tile(ref.cent_sq, 4)
    ref.node_ids = jnp.arange(64, dtype=jnp.int32)
    mine = entries_from_jax(ref, device="cpu")
    np.testing.assert_array_equal(mine.query_entries(query, E).numpy(),
                                  np.asarray(ref.query_entries(query, E)))


@pytest.mark.parametrize("sample", [None, 1500])
def test_kmeans_seed_gives_jax_centroids(duplicated, sample):
    base, _ = duplicated
    x = base[:4000]
    for seed in (0, 5):
        ref = jax_km.kmeans_fit(x, 24, iters=4, seed=seed, sample=sample)
        mine = km.kmeans_fit(x, 24, iters=4, seed=seed, sample=sample,
                             device="cpu")
        np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5)


def _projected(fixture_data, d_lo=16):
    base, query = fixture_data
    w = np.random.default_rng(1).normal(size=(32, d_lo)).astype(np.float32)
    return base, query, base @ w, query @ w


@pytest.mark.parametrize("merge", ["pallas", "exact"])
def test_float16_scan_matches_jax(fixture_data, fixture_gt, merge):
    base, query, blo, qlo = _projected(fixture_data)
    ref = JaxFused(base, blo, chunk=1024, scan_dtype=jnp.float16).search(
        query, qlo, k=10, c=16, merge=merge)
    for dtype in (torch.float16, "float16"):
        idx = FusedScanIndex(base, blo, chunk=1024, scan_dtype=dtype,
                             device="cpu")
        assert idx.x_lo.dtype == torch.float16
        mine = idx.search(query, qlo, k=10, c=16, merge=merge)
        r_mine = recall_at_k(mine[0].numpy(), fixture_gt, 10)
        r_ref = recall_at_k(np.asarray(ref[0]), fixture_gt, 10)
        assert abs(r_mine - r_ref) <= 0.005, (r_mine, r_ref)
        assert (mine[0].numpy() == np.asarray(ref[0])).all(axis=1).mean() \
            >= 0.99


def test_float16_scan_plain_is_exact_products():
    """The plain fp16 scan: fp16 inputs, exact products, fp32 sums."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2048, 32)).astype(np.float16))
    q = torch.from_numpy(rng.normal(size=(40, 32)).astype(np.float16))
    add = torch.zeros(2048)
    vals, ids = st.binned_scan(q, -2 * x, add, bin_size=256)
    s = (-2.0 * x.double() @ q.double().T).view(8, 256, 40)
    np.testing.assert_array_equal(ids.numpy() % 256, s.argmin(1).numpy())
    np.testing.assert_allclose(vals.numpy(), s.amin(1).numpy(), rtol=1e-6)



def _pairs():
    """Each exported JAX entry point beside the port's."""
    import gbnns_tpu.kernels.topk as jtopk
    import gbnns_tpu.search.flat as jflat
    import gbnns_tpu.search.gated as jgated
    import gbnns_tpu.search.graph_index as jgraph
    import gbnns_tpu.search.walker_jax as jwalk
    import gbnns_tpu.search.walker_pallas as jwalkp
    import gbnns_tpu.serve as jserve
    import gbnns_tpu.dimred.pca as jpca
    import gbnns_tpu.dimred.train as jtrain
    import gbnns_tpu.eval.bench as jbench
    import gbnns_tpu.eval.trace as jtrace
    import gbnns_tpu.search.ivf as jivf
    import gbnns_tpu.search.sizing as jsizing
    import gbnns_tpu_torch.kernels.topk as ttopk
    import gbnns_tpu_torch.search.flat as tflat
    import gbnns_tpu_torch.search.gated as tgated
    import gbnns_tpu_torch.search.graph_index as tgraph
    import gbnns_tpu_torch.search.walker as twalk
    import gbnns_tpu_torch.search.walker_payload as twalkp
    import gbnns_tpu_torch.serve as tserve
    import gbnns_tpu_torch.dimred.pca as tpca
    import gbnns_tpu_torch.dimred.train as ttrain
    import gbnns_tpu_torch.eval.bench as tbench
    import gbnns_tpu_torch.eval.trace as ttrace
    import gbnns_tpu_torch.search.ivf as tivf
    import gbnns_tpu_torch.search.sizing as tsizing

    return {
        "FusedScanIndex": (JaxFused.__init__, FusedScanIndex.__init__),
        "build_knn_graph": (jax_kg.build_knn_graph, kg.build_knn_graph),
        "knn_chunked": (jtopk.knn_chunked, ttopk.knn_chunked),
        "knn_fused": (jtopk.knn_fused, ttopk.knn_fused),
        "knn": (jtopk.knn, ttopk.knn),
        "FlatIndex": (JaxFlat.__init__, FlatIndex.__init__),
        "GatedScanIndex": (jgated.GatedScanIndex.__init__,
                           tgated.GatedScanIndex.__init__),
        "GraphIndex.build": (jgraph.GraphIndex.build, tgraph.GraphIndex.build),
        "SearchService": (jserve.SearchService.__init__,
                          tserve.SearchService.__init__),
        "CentroidEntries.build": (JaxEntries.build,
                                  km_entries().build),
        "flat_search": (jflat.flat_search, tflat.flat_search),
        "FlatIndex.search": (JaxFlat.search, FlatIndex.search),
        "beam_search": (jwalk.beam_search, twalk.beam_search),
        "beam_search_pallas": (jwalkp.beam_search_pallas,
                               twalkp.beam_search_pallas),
        "FusedScanIndex.search": (JaxFused.search, FusedScanIndex.search),
        "FusedScanIndex.candidates": (JaxFused.candidates,
                                      FusedScanIndex.candidates),
        "GatedScanIndex.search": (jgated.GatedScanIndex.search,
                                  tgated.GatedScanIndex.search),
        "GraphIndex.search": (jgraph.GraphIndex.search,
                              tgraph.GraphIndex.search),
        "IVFIndex.build": (jivf.IVFIndex.build, tivf.IVFIndex.build),
        "IVFIndex.search": (jivf.IVFIndex.search, tivf.IVFIndex.search),
        "IVFIndex.qslots_for": (jivf.IVFIndex.qslots_for,
                                tivf.IVFIndex.qslots_for),
        "ivf_search": (jivf.ivf_search, tivf.ivf_search),
        "pca_fit": (jpca.pca_fit, tpca.pca_fit),
        "pca_transform": (jpca.pca_transform, tpca.pca_transform),
        "train_projection": (jtrain.train_projection,
                             ttrain.train_projection),
        "save_projection": (jtrain.save_projection, ttrain.save_projection),
        "time_fn": (jbench.time_fn, tbench.time_fn),
        "time_search": (jbench.time_search, tbench.time_search),
        "sweep": (jbench.sweep, tbench.sweep),
        "pareto": (jbench.pareto, tbench.pareto),
        "profile_trace": (jtrace.profile_trace, ttrace.profile_trace),
        "cost_analysis": (jtrace.cost_analysis, ttrace.cost_analysis),
        "memory_analysis": (jtrace.memory_analysis, ttrace.memory_analysis),
        "HbmBreakdown.fits": (jsizing.HbmBreakdown.fits,
                              tsizing.HbmBreakdown.fits),
        "HbmBreakdown.as_dict": (jsizing.HbmBreakdown.as_dict,
                                 tsizing.HbmBreakdown.as_dict),
    }


def km_entries():
    from gbnns_tpu_torch.search.entries import CentroidEntries
    return CentroidEntries


@pytest.mark.parametrize("name", ["FusedScanIndex", "build_knn_graph",
                                  "knn_chunked", "knn_fused", "knn",
                                  "FlatIndex", "GatedScanIndex",
                                  "GraphIndex.build", "SearchService",
                                  "CentroidEntries.build", "flat_search",
                                  "FlatIndex.search", "beam_search",
                                  "beam_search_pallas",
                                  "FusedScanIndex.search",
                                  "FusedScanIndex.candidates",
                                  "GatedScanIndex.search",
                                  "GraphIndex.search", "IVFIndex.build",
                                  "IVFIndex.search", "IVFIndex.qslots_for",
                                  "ivf_search", "pca_fit", "pca_transform",
                                  "train_projection", "save_projection",
                                  "time_fn", "time_search", "sweep",
                                  "pareto", "profile_trace", "cost_analysis",
                                  "memory_analysis", "HbmBreakdown.fits",
                                  "HbmBreakdown.as_dict"])
def test_port_takes_every_jax_keyword_in_its_order(name):
    """Every parameter of the JAX entry point is a parameter of the port's,
    in the same order; the port may add its own (``device``, ``stats``)."""
    ref, mine = _pairs()[name]
    want = [p for p in inspect.signature(ref).parameters
            if p not in ("interpret",)]
    have = list(inspect.signature(mine).parameters)
    missing = [p for p in want if p not in have]
    assert not missing, f"{name} lacks {missing}"
    assert [p for p in have if p in want] == want


def test_payload_walker_answers_to_its_jax_name():
    """JAX callers import the payload walker as ``beam_search_pallas``."""
    from gbnns_tpu_torch.search.walker_payload import (beam_search_pallas,
                                                       beam_search_payload)

    assert beam_search_pallas is beam_search_payload


def test_flat_search_takes_jax_calls(fixture_data):
    """The JAX package's own calls (tests/test_flat.py) run on the port and
    change no result: the port's candidate scan is exact already."""
    base, query = fixture_data
    idx = FlatIndex(base, device="cpu")
    want = idx.search(query, k=10, c=32)
    got = idx.search(query, k=10, c=32, exact=True)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    from gbnns_tpu_torch.search.flat import flat_search

    qf = torch.from_numpy(query)
    ql = qf.to(idx.base_lo.dtype)
    for exact, precision in ((True, "highest"), (False, "default")):
        ids, _ = flat_search(ql, idx.base_lo, qf, idx.base_full, 10, c=32,
                             exact=exact, precision=precision,
                             base_full_sqnorms=idx.base_full_sqnorms)
        assert torch.equal(ids, want[0])


def test_fused_tq_changes_no_result(fixture_data):
    base, query = fixture_data
    a = FusedScanIndex(base, chunk=1024, device="cpu")
    b = FusedScanIndex(base, chunk=1024, tq=64, device="cpu")
    assert b.tq == 64 and a.tq == 1024
    ia, da = a.search(query, k=10, c=16)
    ib, db = b.search(query, k=10, c=16)
    assert torch.equal(ia, ib) and torch.equal(da, db)


@pytest.fixture(scope="module")
def graph_corpus():
    rng = np.random.default_rng(13)
    centers = rng.normal(size=(12, 16)).astype(np.float32) * 3
    return (centers[rng.integers(0, 12, 1500)]
            + rng.normal(size=(1500, 16)).astype(np.float32))


def test_knn_graph_approx_keywords_stay_exact(graph_corpus):
    kw = dict(node_chunk=512, chunk=700, device="cpu")
    exact = kg.build_knn_graph(graph_corpus, 10, **kw)
    approx = kg.build_knn_graph(graph_corpus, 10, exact=False,
                                recall_target=0.9, precision="highest", **kw)
    np.testing.assert_array_equal(approx, exact)


def test_knn_graph_bf16_matches_jax(graph_corpus):
    """``dtype=bfloat16``: the graph of the bf16-rounded vectors with fp32
    sums, as JAX's; rows differ only where two candidates' exact distances
    (of the rounded vectors) tie within 1e-5 of the largest."""
    kw = dict(node_chunk=512, chunk=700, connect=False, reverse_frac=0.0)
    ref = jax_kg.build_knn_graph(graph_corpus, 10, dtype=jnp.bfloat16, **kw)
    for dtype in (torch.bfloat16, "bfloat16", jnp.bfloat16):
        mine = kg.build_knn_graph(graph_corpus, 10, dtype=dtype,
                                  device="cpu", **kw)
        xr = torch.from_numpy(graph_corpus).to(torch.bfloat16).double()
        miss = np.nonzero(mine != ref)
        rows = torch.from_numpy(miss[0])
        d_mine = ((xr[rows] - xr[torch.from_numpy(mine[miss])]) ** 2).sum(-1)
        d_ref = ((xr[rows] - xr[torch.from_numpy(ref[miss])]) ** 2).sum(-1)
        scale = ((xr[:64, None] - xr[None, :]) ** 2).sum(-1).max()
        assert ((d_mine - d_ref).abs() <= 1e-5 * scale).all()
        assert (mine == ref).all(axis=1).mean() >= 0.95
    # the bf16 graph is another graph than the f32 one here
    f32 = kg.build_knn_graph(graph_corpus, 10, device="cpu", **kw)
    assert not np.array_equal(mine, f32)
    with pytest.raises(ValueError, match="float type"):
        kg.build_knn_graph(graph_corpus, 10, dtype=torch.int8, device="cpu")


def test_knn_chunked_approx_keywords_stay_exact(duplicated):
    base, query = duplicated
    q, x = torch.from_numpy(query), torch.from_numpy(base)
    ref = knn_chunked(q, x, 10, chunk=5000)
    for kw in (dict(exact=False), dict(exact=False, recall_target=0.9),
               dict(precision="default")):
        got = knn_chunked(q, x, 10, chunk=5000, **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = knn_fused(q, x, 10, chunk=5000, q_chunk=100, exact=False)
    assert torch.equal(got[1], ref[1])
    got = knn(query, base, 10, chunk=5000, exact=False, recall_target=0.5,
              precision="high", device="cpu")
    assert torch.equal(got[1], ref[1])
