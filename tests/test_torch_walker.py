"""The beam walkers and the row gather: the port (on the CPU, through the
plain version of kernel K3) against the JAX package's walkers and its Pallas
gather (interpret mode), on the small corpus of tests/test_walker_pallas.py
(n = 2,048, d = 24, K = 12).

Tolerances: the gather and the payload layout are bit-exact. Walk distances
agree within 1e-5 of the scale of the l2 expansion ‖q‖² − 2q·x + ‖x‖² (its
terms are that large, and fp32 sums in another order move it by ulps of
them); ids equal on ≥ 98 % of query rows, n_dist within 2 %, recall@10 after
re-rank within 0.005 (bf16 payload: 0.01). The port's f32 payload walker
equals the port's plain walker exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.build.knn_graph import build_knn_graph as jax_build
from gbnns_tpu.io.synthetic import SyntheticSpec, make_synthetic
from gbnns_tpu.kernels.gather_pallas import dma_row_gather
from gbnns_tpu.search import walker_jax as jw
from gbnns_tpu.search import walker_pallas as jp
from gbnns_tpu_torch.eval.recall import recall_at_k
from gbnns_tpu_torch.kernels import gather
from gbnns_tpu_torch.kernels.topk import knn
from gbnns_tpu_torch.search import walker, walker_payload as wp
from gbnns_tpu_torch.search.rerank import rerank


@pytest.fixture(scope="module")
def small_index():
    data = make_synthetic(SyntheticSpec(n_base=2048, n_query=64, dim=24,
                                        n_clusters=16, seed=11))
    base, query = data["base"], data["query"]
    graph = jax_build(base, 12, chunk=1024, node_chunk=1024)
    gt = knn(query, base, 10, device="cpu")[1].numpy()
    return base, query, graph, gt


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def test_row_gather_plain_matches_dma_row_gather():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((64, 8, 128)).astype(np.float32)
    src.view(np.uint32)[5, 0, :4] = [0x7FC00001, 0xFF800000, 0, 0x80000000]
    idx = rng.integers(0, 64, size=37).astype(np.int32)
    ref = np.asarray(dma_row_gather(jnp.asarray(src), jnp.asarray(idx),
                                    interpret=True)).reshape(37, 1024)
    payload = torch.from_numpy(src.reshape(64, 1024))
    before = gather.launches["row_gather"]
    for fn in (gather.row_gather_plain, gather.row_gather):
        out = fn(payload, torch.from_numpy(idx))
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
    assert gather.launches["row_gather"] == before   # the CPU launches none


def test_row_gather_rejects_bad_input():
    payload = torch.zeros((10, 8))
    for ids in ([0, 10], [-1, 3]):
        with pytest.raises(IndexError):
            gather.row_gather(payload, torch.tensor(ids, dtype=torch.int32))
    with pytest.raises(ValueError):   # rows must be whole 16-byte words
        gather.row_gather(torch.zeros((10, 6)), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather.row_gather(payload, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        gather.row_gather(payload.double(), torch.zeros(2, dtype=torch.int32))
    assert gather.row_gather(payload, torch.zeros(0, dtype=torch.int32)) \
        .shape == (0, 8)


@pytest.mark.parametrize("vec_dtype", ["float32", "bfloat16"])
def test_pack_and_decode_match_jax(vec_dtype):
    rng = np.random.default_rng(1)
    base = rng.standard_normal((100, 16)).astype(np.float32)
    graph = rng.integers(0, 100, size=(100, 8)).astype(np.int32)
    graph[3, 5] = -1
    ref = jp.pack_hop_payload(graph, base, vec_dtype=vec_dtype, node_chunk=33)
    mine = wp.pack_hop_payload(graph, base, vec_dtype=vec_dtype,
                               node_chunk=33, device="cpu")
    used = ref.vec_words + ref.K
    assert mine.vec_words == ref.vec_words and mine.bf16 == ref.bf16
    assert mine.words == -(-used // 32) * 32 and ref.words % 1024 == 0
    ref_rows = np.asarray(ref.data).reshape(100, -1)
    np.testing.assert_array_equal(_bits(mine.data.numpy()[:, :used]),
                                  _bits(ref_rows[:, :used]))
    assert not mine.data[:, used:].any()
    rows = [3, 77]
    jv, jsq, jids = jp._decode(jnp.asarray(ref.data)[jnp.asarray(rows)], K=8,
                               d=16, vec_words=ref.vec_words,
                               bf16=ref.bf16)
    pv, psq, pids = wp._decode(mine.data[rows], K=8, d=16,
                               vec_words=mine.vec_words, bf16=mine.bf16)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(psq.numpy(), np.asarray(jsq), rtol=1e-6)
    # the port's payload re-rowed from JAX's is the port's own
    again = wp.payload_from_jax(ref, device="cpu")
    assert torch.equal(again.data.view(torch.int32),
                       mine.data.view(torch.int32))


def _walk_agrees(mine, ref, query, base, gt, *, r10_tol=0.005):
    ids, rids = mine.ids.numpy(), np.array(ref.ids)
    assert (ids == rids).all(axis=1).mean() >= 0.98
    scale = (query.astype(np.float64) ** 2).sum(-1)[:, None]
    np.testing.assert_array_less(
        np.abs(mine.dists.numpy() - np.asarray(ref.dists))
        - 1e-5 * (np.abs(np.asarray(ref.dists)) + scale), 0.0)
    nd, rnd = int(mine.n_dist.sum()), int(np.asarray(ref.n_dist).sum())
    assert abs(nd - rnd) <= 0.02 * rnd
    qf = torch.from_numpy(query)
    bf = torch.from_numpy(base)
    r_mine = recall_at_k(rerank(qf, bf, mine.ids, 10)[0].numpy(), gt, 10)
    r_ref = recall_at_k(rerank(qf, bf, torch.from_numpy(rids), 10)[0]
                        .numpy(), gt, 10)
    assert abs(r_mine - r_ref) <= r10_tol
    return r_mine


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("visited_mode", ["beam", "exact"])
def test_beam_search_matches_jax(small_index, expand, visited_mode):
    base, query, graph, gt = small_index
    kw = dict(ef=24, max_hops=48, expand=expand, visited_mode=visited_mode)
    ref = jw.beam_search(jnp.asarray(query), jnp.asarray(base),
                         jnp.asarray(graph), jw.default_entry_ids(2048, 8),
                         **kw)
    entries = walker.default_entry_ids(2048, 8)
    np.testing.assert_array_equal(entries.numpy(),
                                  np.asarray(jw.default_entry_ids(2048, 8)))
    mine = walker.beam_search(torch.from_numpy(query), torch.from_numpy(base),
                              torch.from_numpy(graph), entries, **kw)
    assert mine.hops == int(ref.hops)
    assert _walk_agrees(mine, ref, query, base, gt) > 0.9


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("visited_mode", ["beam", "exact"])
def test_payload_walker_matches_jax_and_port(small_index, expand,
                                             visited_mode):
    """f32 payload: against JAX's payload walker (its Pallas gather in
    interpret mode), and identical to the port's plain walker."""
    base, query, graph, gt = small_index
    kw = dict(ef=24, max_hops=48, expand=expand, visited_mode=visited_mode)
    ref = jp.beam_search_pallas(query, jp.pack_hop_payload(graph, base), base,
                                jw.default_entry_ids(2048, 8), **kw)
    entries = walker.default_entry_ids(2048, 8)
    payload = wp.pack_hop_payload(graph, base, device="cpu")
    mine = wp.beam_search_payload(torch.from_numpy(query), payload,
                                  torch.from_numpy(base), entries, **kw)
    _walk_agrees(mine, ref, query, base, gt)
    plain = walker.beam_search(torch.from_numpy(query), torch.from_numpy(base),
                               torch.from_numpy(graph), entries, **kw)
    assert torch.equal(mine.ids, plain.ids)
    assert torch.equal(mine.dists, plain.dists)
    assert torch.equal(mine.n_dist, plain.n_dist) and mine.hops == plain.hops


def test_payload_walker_per_query_entries_and_gather_hook(small_index):
    """(B, E) entries; the walk through the wrapper equals the walk through
    the plain gather passed in, as chip_smoke.py holds them on the card."""
    base, query, graph, _ = small_index
    rng = np.random.default_rng(4)
    ent = torch.from_numpy(rng.integers(0, 2048, (64, 6)).astype(np.int32))
    payload = wp.pack_hop_payload(graph, base, vec_dtype="bfloat16",
                                  device="cpu")
    runs = [wp.beam_search_payload(torch.from_numpy(query), payload,
                                   torch.from_numpy(base), ent, ef=16, gather=g)
            for g in (gather.row_gather, gather.row_gather_plain)]
    assert torch.equal(runs[0].ids, runs[1].ids)
    assert torch.equal(runs[0].n_dist, runs[1].n_dist)
    assert runs[0].hops == runs[1].hops


def test_bf16_payload_recall_matches_jax(small_index):
    base, query, graph, gt = small_index
    ref = jp.beam_search_pallas(
        query, jp.pack_hop_payload(graph, base, vec_dtype="bfloat16"), base,
        jw.default_entry_ids(2048, 8), ef=32, max_hops=64)
    mine = wp.beam_search_payload(
        torch.from_numpy(query),
        wp.pack_hop_payload(graph, base, vec_dtype="bfloat16", device="cpu"),
        torch.from_numpy(base), walker.default_entry_ids(2048, 8), ef=32,
        max_hops=64)
    qf, bf = torch.from_numpy(query), torch.from_numpy(base)
    r_mine = recall_at_k(rerank(qf, bf, mine.ids, 10)[0].numpy(), gt, 10)
    r_ref = recall_at_k(rerank(qf, bf, torch.from_numpy(np.array(ref.ids)),
                               10)[0].numpy(), gt, 10)
    assert abs(r_mine - r_ref) <= 0.01 and r_mine > 0.9


def test_walker_helpers_match_jax():
    rng = np.random.default_rng(5)
    nbrs = rng.integers(-1, 40, size=(7, 48)).astype(np.int32)
    np.testing.assert_array_equal(
        walker.intra_dedup_mask(torch.from_numpy(nbrs)).numpy(),
        np.asarray(jw.intra_dedup_mask(jnp.asarray(nbrs), 48)))
    ids = rng.integers(0, 99, size=(7, 12)).astype(np.int32)
    exp = rng.random((7, 12)) < 0.5
    d = np.sort(rng.random((7, 12)).astype(np.float32), axis=1)
    got = walker.select_frontier(torch.from_numpy(ids), torch.from_numpy(exp), 4)
    ref = jw.select_frontier(jnp.asarray(ids), jnp.asarray(d),
                             jnp.asarray(exp), 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    cd = rng.random((7, 20)).astype(np.float32)
    cd[:, ::3] = d[:, :1]                     # ties with pool members
    cid = rng.integers(0, 99, size=(7, 20)).astype(np.int32)
    cinv = rng.random((7, 20)) < 0.3
    got = walker.merge_pool(*(torch.from_numpy(a) for a in
                              (ids, d, exp, cid, cd, cinv)), 12)
    ref = jw.merge_pool(*(jnp.asarray(a) for a in (ids, d, exp, cid, cd, cinv)),
                        12)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    packed, sq = walker.pack_neighbors(ids[:, :3] % 7, d)
    rp, rsq = jw.pack_neighbors(ids[:, :3] % 7, d)
    np.testing.assert_array_equal(packed, np.asarray(rp))
    np.testing.assert_array_equal(sq, np.asarray(rsq))


def test_packed_neighbors_walk_equals_plain(small_index):
    base, query, graph, _ = small_index
    pv, psq = walker.pack_neighbors(graph, base)
    args = (torch.from_numpy(query), torch.from_numpy(base),
            torch.from_numpy(graph), walker.default_entry_ids(2048, 8))
    a = walker.beam_search(*args, ef=24, packed_vecs=torch.from_numpy(pv),
                           packed_sqnorms=torch.from_numpy(psq))
    b = walker.beam_search(*args, ef=24)
    assert (a.ids == b.ids).all(dim=1).float().mean() >= 0.98


def test_walker_refuses_bad_options(small_index):
    base, query, graph, _ = small_index
    args = (torch.from_numpy(query), torch.from_numpy(base),
            torch.from_numpy(graph))
    with pytest.raises(ValueError):
        walker.beam_search(*args, walker.default_entry_ids(2048, 8), ef=4)
    with pytest.raises(ValueError):
        walker.beam_search(*args, walker.default_entry_ids(2048, 8), ef=24,
                           visited_mode="bloom")
    with pytest.raises(ValueError):
        walker.beam_search(*args, walker.default_entry_ids(2048, 8), ef=24,
                           metric="cos")


def test_exact_visited_walk_matches_the_cpp_oracle(small_index):
    """visited_mode="exact" with expand=1 reproduces the C++ reference
    searcher's pools (as the JAX walker's own gate holds it: sets agree on
    ≥ 90 % of each pool, fp ties may reorder an expansion)."""
    from gbnns_tpu import native

    if not native.available():
        pytest.skip("the C++ reference searcher is not built here")
    from gbnns_tpu_torch.build.knn_graph import build_knn_graph

    base, query, _, _ = small_index
    # the oracle models the reference's pure kNN graph: no reverse edges
    graph = build_knn_graph(base, 16, chunk=1024, node_chunk=1024,
                            reverse_frac=0.0, device="cpu")
    entries = walker.default_entry_ids(2048, 16)
    c_ids, _, _ = native.beam_search(base, graph, query[:32],
                                     entries.numpy(), ef=32)
    res = walker.beam_search(torch.from_numpy(query[:32]),
                             torch.from_numpy(base), torch.from_numpy(graph),
                             entries, ef=32, visited_mode="exact", expand=1)
    agree = np.mean([
        len(np.intersect1d(a[a >= 0], b[b >= 0])) / max((a >= 0).sum(), 1)
        for a, b in zip(c_ids, res.ids.numpy())])
    assert agree >= 0.9, agree
