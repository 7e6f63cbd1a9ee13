"""FusedScanIndex variants against the JAX package's on the fixture corpus:
angular metric, bf16 re-rank, packed selection, approx merge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.kernels.scan_topk_pallas import FusedScanIndex as JaxIndex
from gbnns_tpu_torch.eval.recall import recall_at_k
from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex


def _check(mine, ref, gt):
    mi, ri = mine[0].numpy(), np.asarray(ref[0])
    assert (mi == ri).all(axis=1).mean() >= 0.99
    assert abs(recall_at_k(mi, gt, 10) - recall_at_k(ri, gt, 10)) <= 0.01


def test_angular(fixture_data):
    base, query = fixture_data
    base = base / np.linalg.norm(base, axis=1, keepdims=True)
    query = query / np.linalg.norm(query, axis=1, keepdims=True)
    gt = np.argsort(-(query @ base.T), axis=1, kind="stable")[:, :10]
    ref = JaxIndex(base, metric="angular", chunk=1024).search(
        query, k=10, c=16, merge="pallas")
    mine = FusedScanIndex(base, metric="angular", chunk=1024,
                          device="cpu").search(query, k=10, c=16,
                                               merge="pallas")
    _check(mine, ref, gt)


def test_bf16_rerank(fixture_data, fixture_gt):
    base, query = fixture_data
    ref = JaxIndex(base, chunk=1024, rerank_dtype=jnp.bfloat16).search(
        query, k=10, c=16, merge="exact")
    idx = FusedScanIndex(base, chunk=1024, rerank_dtype="bfloat16",
                         device="cpu")
    assert idx.base_full.dtype == torch.bfloat16
    assert idx.base_sq.dtype == torch.float32
    mine = idx.search(query, k=10, c=16, merge="exact")
    _check(mine, ref, fixture_gt)
    np.testing.assert_allclose(mine[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("merge", ["pallas", "approx"])
def test_packed(fixture_data, fixture_gt, merge):
    base, query = fixture_data
    ref = JaxIndex(base, chunk=1024, packed=True).search(
        query, k=10, c=16, merge=merge)
    mine = FusedScanIndex(base, chunk=1024, packed=True, device="cpu").search(
        query, k=10, c=16, merge=merge)
    _check(mine, ref, fixture_gt)


def test_cpu_default_merge_is_exact(fixture_data):
    base, query = fixture_data
    idx = FusedScanIndex(base, chunk=1024, device="cpu")
    a = idx.candidates(query, c=16)
    b = idx.candidates(query, c=16, merge="exact")
    assert torch.equal(a, b)
