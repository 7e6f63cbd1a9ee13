"""The port's sharded search (``search/sharded.py``) against the JAX
package's on the suite's fixture corpus (2,048 x 32), over an 8-shard mesh
on the CPU (``make_mesh(8, device="cpu")``) beside JAX's forced 8-device
CPU mesh, whose Pallas kernels run in interpret mode.

Tolerances: the exact engines (graph, flat, graph_pallas) return equal ids
over one JAX index carried in with ``sharded_from_jax``; the fused engine is
held as ``tests/test_torch_fused_index.py`` holds ``FusedScanIndex`` (at
least 99 % of rows equal, distances within rtol 1e-5 / atol 1e-4); every
engine's R@10 lies within 0.005 of JAX's. The builds' graphs are equal
except at rows whose differing neighbours tie in distance (1e-5 relative).
"""

import jax
import numpy as np
import pytest
import torch

from gbnns_tpu.search import sharded as jax_sharded
from gbnns_tpu.search import sizing as jax_sizing
from gbnns_tpu_torch.eval.recall import recall_at_k
from gbnns_tpu_torch.search import sizing
from gbnns_tpu_torch.search.sharded import (build_sharded_index,
                                            fused_geometry, make_mesh,
                                            sharded_from_jax, sharded_search)

BUILD_KW = dict(chunk=1024, node_chunk=1024)
ENGINES = [("graph", {}), ("flat", {}), ("fused", {}),
           ("fused", {"scan_dtype": "int8"}), ("graph_pallas", {})]


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax_sharded.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jax_index(fixture_data, jax_mesh):
    base, _ = fixture_data
    return jax_sharded.build_sharded_index(base, 8, jax_mesh,
                                           with_payload=True, ncent=16,
                                           build_kwargs=BUILD_KW)


@pytest.fixture(scope="module")
def carried(jax_index, mesh):
    return sharded_from_jax(jax_index, mesh)


def _graphs_equal_but_ties(mine, ref, base_lo, n_shard):
    """Rows may differ only where the differing neighbours tie in distance
    with the ones they replace; returns the count of such rows."""
    differ = 0
    for p in range(ref.shape[0]):
        rows = np.nonzero((mine[p] != ref[p]).any(axis=1))[0]
        x = base_lo[p * n_shard:(p + 1) * n_shard].astype(np.float64)
        for r in rows:
            dm = ((x[mine[p, r]] - x[r]) ** 2).sum(-1)
            dr = ((x[ref[p, r]] - x[r]) ** 2).sum(-1)
            np.testing.assert_allclose(np.sort(dm), np.sort(dr), rtol=1e-5,
                                       atol=1e-5)
        differ += rows.size
    return differ


def test_make_mesh_puts_every_shard_on_the_named_device():
    m = make_mesh(4, device="cpu")
    assert m.size == 4 and m.axis == "shards"
    assert set(m.devices) == {torch.device("cpu")}
    assert make_mesh(device="cpu").size == 1


def test_build_matches_jax(fixture_data, jax_index, mesh):
    base, _ = fixture_data
    mine = build_sharded_index(base, 8, mesh, with_payload=True, ncent=16,
                               build_kwargs=BUILD_KW)
    assert (mine.n, mine.n_shard) == (jax_index.n, jax_index.n_shard)
    assert len(mine.base_lo) == 8 and mine.payload_meta[:2] == (8, 32)
    for name in ("base_lo", "base_full", "graph", "cent_ids", "cent"):
        got = np.stack([t.numpy() for t in getattr(mine, name)])
        assert got.shape == np.asarray(getattr(jax_index, name)).shape, name
    graph = np.stack([g.numpy() for g in mine.graph])
    assert _graphs_equal_but_ties(graph, np.asarray(jax_index.graph), base,
                                  mine.n_shard) <= 8
    assert (graph >= 0).all() and (graph < mine.n_shard).all()
    cent_ids = np.stack([c.numpy() for c in mine.cent_ids])
    assert (cent_ids >= 0).all() and (cent_ids < mine.n_shard).all()
    for hp in mine.payload:
        assert (hp.n, hp.K, hp.d) == (mine.n_shard, 8, 32)


def test_serial_build_matches_jax(fixture_data, jax_mesh, mesh):
    base, _ = fixture_data
    ref = jax_sharded.build_sharded_index(base[:1024], 6, jax_mesh,
                                          parallel_build=False,
                                          build_kwargs=BUILD_KW)
    mine = build_sharded_index(base[:1024], 6, mesh, parallel_build=False,
                               build_kwargs=BUILD_KW)
    graph = np.stack([g.numpy() for g in mine.graph])
    assert graph.shape == np.asarray(ref.graph).shape == (8, 128, 6)
    assert _graphs_equal_but_ties(graph, np.asarray(ref.graph), base[:1024],
                                  128) <= 4


@pytest.mark.parametrize("engine,kw", ENGINES,
                         ids=["graph", "flat", "fused", "fused-int8",
                              "graph_pallas"])
def test_search_matches_jax(fixture_data, fixture_gt, jax_index, carried,
                            engine, kw):
    _, query = fixture_data
    ref_i, ref_d = jax_sharded.sharded_search(jax_index, query, 10, ef=32,
                                              engine=engine, **kw)
    ref_i, ref_d = np.asarray(ref_i), np.asarray(ref_d)
    ids, dists = sharded_search(carried, query, 10, ef=32, engine=engine,
                                **kw)
    assert ids.dtype == torch.int32 and ids.shape == (query.shape[0], 10)
    ids, dists = ids.numpy(), dists.numpy()
    if engine == "fused":
        assert (ids == ref_i).all(axis=1).mean() >= 0.99
    else:
        np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_allclose(dists, ref_d, rtol=1e-5, atol=1e-4)
    assert abs(recall_at_k(ids, fixture_gt, 10)
               - recall_at_k(ref_i, fixture_gt, 10)) <= 0.005
    assert (np.diff(dists, axis=1) >= -1e-5).all()


def test_own_build_searches_as_jax(fixture_data, fixture_gt, jax_mesh, mesh):
    """Two builds, two searches: the port's index, built by the port, gives
    JAX's recall on the fused scan (which needs no graph)."""
    base, query = fixture_data
    ref = jax_sharded.build_sharded_index(base, 8, jax_mesh, with_graph=False)
    mine = build_sharded_index(base, 8, mesh, with_graph=False)
    assert mine.graph[0].shape == (mine.n_shard, 0)
    ri, _ = jax_sharded.sharded_search(ref, query, 10, ef=64, engine="fused")
    ids, _ = sharded_search(mine, query, 10, ef=64, engine="fused")
    assert (ids.numpy() == np.asarray(ri)).all(axis=1).mean() >= 0.99
    assert abs(recall_at_k(ids.numpy(), fixture_gt, 10)
               - recall_at_k(np.asarray(ri), fixture_gt, 10)) <= 0.005


def test_padding_never_returned(fixture_data, jax_mesh, mesh):
    """n = 2,041 over 8 shards: the tail shard's sentinel rows are JAX's,
    and no search returns an id >= n."""
    base, query = fixture_data
    ref = jax_sharded.build_sharded_index(base[:2041], 8, jax_mesh,
                                          build_kwargs=BUILD_KW)
    mine = build_sharded_index(base[:2041], 8, mesh, build_kwargs=BUILD_KW)
    np.testing.assert_array_equal(mine.base_full[-1].numpy(),
                                  np.asarray(ref.base_full)[-1])
    np.testing.assert_array_equal(mine.base_lo[-1].numpy(),
                                  np.asarray(ref.base_lo)[-1])
    for engine in ("graph", "flat", "fused"):
        ids, dists = sharded_search(mine, query, 10, ef=32, engine=engine)
        assert (ids.numpy() < 2041).all() and (ids.numpy() >= 0).all()
    ri, _ = jax_sharded.sharded_search(ref, query, 10, ef=32)
    ids, _ = sharded_search(sharded_from_jax(ref, mesh), query, 10, ef=32)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ri))


def test_int8_scale_leaves_out_the_sentinels(fixture_data, jax_mesh, mesh):
    """n = 2,041: the JAX module takes the tail shard's int8 scale over its
    sentinel rows too (a far constant), which rounds the shard's real rows
    to 0; the port takes it over the real rows, so its int8 search keeps
    the bf16 search's recall where JAX's falls."""
    base, query = fixture_data
    d2 = ((query[:, None, :] - base[None, :2041, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10]
    ref = jax_sharded.build_sharded_index(base[:2041], 8, jax_mesh,
                                          with_graph=False)
    mine = build_sharded_index(base[:2041], 8, mesh, with_graph=False)
    r = {}
    for dt in ("bfloat16", "int8"):
        ids, _ = sharded_search(mine, query, 10, ef=32, engine="fused",
                                scan_dtype=dt)
        r[dt] = recall_at_k(ids.numpy(), gt, 10)
    ji, _ = jax_sharded.sharded_search(ref, query, 10, ef=32,
                                       engine="fused", scan_dtype="int8")
    r_jax = recall_at_k(np.asarray(ji), gt, 10)
    assert r["int8"] >= r["bfloat16"] - 0.01
    assert r_jax < r["int8"] - 0.05


def test_ip_padding_is_zeros(fixture_data, mesh):
    base, _ = fixture_data
    idx = build_sharded_index(base[:2041], 8, mesh, metric="ip",
                              with_graph=False)
    assert not idx.base_full[-1][-7:].any()


@pytest.mark.parametrize("engine", ["flat", "graph"])
def test_duplicates_across_shards_resolve_to_the_lower_shard(
        fixture_data, jax_mesh, mesh, engine):
    """Every shard holds the same 256 rows: each neighbour ties across all
    8 shards, and the merge orders its copies by shard, shard 0 first, as
    JAX's ``lax.top_k`` over the shard-major pairs does."""
    base, query = fixture_data
    tiled = np.tile(base[:256], (8, 1))
    ref = jax_sharded.build_sharded_index(tiled, 8, jax_mesh,
                                          build_kwargs=BUILD_KW)
    ri, _ = jax_sharded.sharded_search(ref, query, 10, ef=32, engine=engine)
    ids, dists = sharded_search(sharded_from_jax(ref, mesh), query, 10,
                                ef=32, engine=engine)
    ids, dists = ids.numpy(), dists.numpy()
    np.testing.assert_array_equal(ids, np.asarray(ri))
    assert (ids[:, 0] < 256).all()
    tied = dists[:, 1:] == dists[:, :-1]
    assert tied.any() and (ids[:, 1:] > ids[:, :-1])[tied].all()


def test_refusals(fixture_data, carried, mesh):
    from gbnns_tpu_torch.dimred.pca import pca_fit, pca_transform

    base, query = fixture_data
    scan_only = build_sharded_index(base, 8, mesh, with_graph=False)
    with pytest.raises(ValueError, match="with_graph"):
        sharded_search(scan_only, query, 10, ef=32, engine="graph")
    with pytest.raises(ValueError, match="with_payload"):
        sharded_search(scan_only, query, 10, ef=32, engine="graph_pallas")
    with pytest.raises(ValueError, match="unknown engine"):
        sharded_search(carried, query, 10, ef=32, engine="ivf")
    with pytest.raises(ValueError, match="with_payload=True needs"):
        build_sharded_index(base, 8, mesh, with_graph=False,
                            with_payload=True)
    m = pca_fit(base, 8, device="cpu")
    idx = build_sharded_index(base, 8, mesh, base_lo=pca_transform(
        m, base, device="cpu"), with_graph=False)
    with pytest.raises(ValueError, match="full-dim queries"):
        sharded_search(idx, pca_transform(m, query, device="cpu"), 10,
                       ef=32, engine="flat")


@pytest.mark.parametrize("n_shard,ef,want", [
    (125_000, 32, (16384, 512, 131072)), (256, 32, (256, 8, 256)),
    (256, 48, (256, 8, 256)), (3000, 300, (4096, 8, 4096))])
def test_fused_geometry(n_shard, ef, want):
    """The JAX module's per-shard scan geometry; at n = 1M over 8 shards
    and ef 32 the bins are 512 rows (the tensor-core route)."""
    assert fused_geometry(n_shard, ef) == want


@pytest.mark.parametrize("engine", ["fused", "graph_pallas"])
@pytest.mark.parametrize("n,chips,d,d_lo,K", [(10_000_000, 8, 96, 32, 32),
                                              (1_000_000, 4, 960, 128, 16)])
def test_sharded_sizing_equals_jax(engine, n, chips, d, d_lo, K):
    want = jax_sizing.sharded_per_chip_hbm(n, chips, d, d_lo, K,
                                           engine=engine).as_dict()
    got = sizing.sharded_per_chip_hbm(n, chips, d, d_lo, K, engine=engine,
                                      row_words=1024).as_dict()
    assert got == want
    mine = sizing.sharded_per_chip_hbm(n, chips, d, d_lo, K, engine=engine)
    assert mine.payload_bytes <= got["payload_bytes"]
    with pytest.raises(ValueError):
        sizing.sharded_per_chip_hbm(n, chips, d, d_lo, K, engine="flat")
