"""Repaired faults of the port, each held against the JAX package on the CPU:

* exact top-k keeps the lower index on ties, as ``lax.top_k`` does (exact
  kNN, ground truth, the flat index, the centroid entries);
* k-means draws its sample and its start as the JAX package does, so one
  seed gives the same centroids;
* the fused scan takes float16, as the JAX one does.

Inputs come from numpy with a seed; JAX runs on the CPU (the Pallas scan in
interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.build import kmeans as jax_km
from gbnns_tpu.eval.recall import exact_ground_truth as jax_gt
from gbnns_tpu.kernels.scan_topk_pallas import FusedScanIndex as JaxFused
from gbnns_tpu.kernels.topk import knn as jax_knn
from gbnns_tpu.search.entries import CentroidEntries as JaxEntries
from gbnns_tpu.search.flat import FlatIndex as JaxFlat
from gbnns_tpu_torch.build import kmeans as km
from gbnns_tpu_torch.eval.recall import exact_ground_truth, recall_at_k
from gbnns_tpu_torch.kernels import scan_topk as st
from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex
from gbnns_tpu_torch.kernels.topk import knn, smallest_k
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

