"""FusedScanIndex: the port (on the CPU, through the kernels' plain versions)
against the JAX package's (interpret mode), on the suite's fixture corpus.
Both get the same ``chunk``, which sets the count of padding bins."""

import numpy as np
import pytest
import torch

from gbnns_tpu.kernels.scan_topk_pallas import FusedScanIndex as JaxIndex
from gbnns_tpu_torch.eval.recall import recall_at_k
from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex


def _projected(fixture_data, d_lo=16):
    base, query = fixture_data
    w = np.random.default_rng(1).normal(size=(32, d_lo)).astype(np.float32)
    return base, query, base @ w, query @ w


def _agree(mine, ref, gt):
    mi, ri = mine[0].numpy(), np.asarray(ref[0])
    assert (mi == ri).all(axis=1).mean() >= 0.99
    assert abs(recall_at_k(mi, gt, 10) - recall_at_k(ri, gt, 10)) <= 0.01
    np.testing.assert_allclose(mine[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("scan_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("merge", ["pallas", "exact"])
def test_fused_index_matches_jax(fixture_data, fixture_gt, scan_dtype, merge):
    base, query, blo, qlo = _projected(fixture_data)
    jkw = {} if scan_dtype == "bfloat16" else dict(scan_dtype="int8")
    ref = JaxIndex(base, blo, chunk=1024, **jkw).search(query, qlo, k=10,
                                                        c=16, merge=merge)
    mine = FusedScanIndex(base, blo, chunk=1024, scan_dtype=scan_dtype,
                          device="cpu").search(query, qlo, k=10, c=16,
                                               merge=merge)
    _agree(mine, ref, fixture_gt)


def test_candidates_are_the_same_pool(fixture_data):
    base, query, blo, qlo = _projected(fixture_data)
    ref = np.asarray(JaxIndex(base, blo, chunk=1024).candidates(
        qlo, c=16, merge="pallas"))
    mine = FusedScanIndex(base, blo, chunk=1024, device="cpu").candidates(
        qlo, c=16, merge="pallas").numpy()
    assert mine.shape == ref.shape == (query.shape[0], 16)
    assert (mine == ref).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize("n", [100, 700, 2048, 20000, 70000])
def test_small_corpus_bin_cap_matches_jax(n):
    x = np.random.default_rng(n).normal(size=(n, 8)).astype(np.float32)
    ref = JaxIndex(x, chunk=1024)
    mine = FusedScanIndex(x, chunk=1024, device="cpu")
    assert mine.bin_size == ref.bin_size
    assert mine.x_lo.shape[0] == ref.x_lo.shape[0]
    np.testing.assert_array_equal(mine.addvec.numpy(), np.asarray(ref.addvec))


def test_int8_quantization_matches_jax(fixture_data):
    base, _, blo, _ = _projected(fixture_data)
    ref = JaxIndex(base, blo, chunk=1024, scan_dtype="int8")
    mine = FusedScanIndex(base, blo, chunk=1024, scan_dtype="int8",
                          device="cpu")
    assert mine.sx == ref.sx
    np.testing.assert_array_equal(mine.x_lo.numpy()[:, :16],
                                  np.asarray(ref.x_lo))
    assert not mine.x_lo.numpy()[:, 16:].any()   # zero width padding
    np.testing.assert_array_equal(mine.addvec.numpy(), np.asarray(ref.addvec))


def test_padding_is_never_returned():
    rng = np.random.default_rng(2)
    base = rng.normal(size=(700, 16)).astype(np.float32)
    query = rng.normal(size=(16, 16)).astype(np.float32)
    ids, _ = FusedScanIndex(base, bin_size=64, chunk=256,
                            device="cpu").search(query, k=5, c=16,
                                                 merge="pallas")
    assert 0 <= ids.min() and ids.max() < 700


@pytest.mark.parametrize("scan_dtype,d_lo", [("float32", 32),
                                              ("bfloat16", 160),
                                              ("bfloat16", 256)])
@pytest.mark.parametrize("merge", ["pallas", "exact"])
def test_fp32_and_wide_scans_match_jax(fixture_data, fixture_gt, scan_dtype,
                                       d_lo, merge):
    """An fp32 scan and reduced widths above 128, which JAX's index takes,
    agree with it at the tolerances of the bf16 and int8 cases."""
    base, query, blo, qlo = _projected(fixture_data, d_lo)
    ref = JaxIndex(base, blo, chunk=1024, scan_dtype=scan_dtype).search(
        query, qlo, k=10, c=16, merge=merge)
    mine = FusedScanIndex(base, blo, chunk=1024, scan_dtype=scan_dtype,
                          device="cpu")
    assert mine.x_lo.dtype == getattr(torch, scan_dtype)
    assert mine.x_lo.shape[1] == max(32, d_lo)
    _agree(mine.search(query, qlo, k=10, c=16, merge=merge), ref, fixture_gt)


def test_float32_and_width_200_are_taken():
    """Once refused: an fp32 scan, and a width of 200 (padded to 208)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    idx = FusedScanIndex(x, scan_dtype="float32", device="cpu")
    assert idx.x_lo.dtype == torch.float32 and idx.x_lo.shape[1] == 16
    ids, _ = idx.search(x[:5], k=1, c=8)
    assert ids[:, 0].tolist() == list(range(5))
    wide = rng.normal(size=(300, 200)).astype(np.float32)
    idx = FusedScanIndex(wide, device="cpu")
    assert idx.x_lo.shape[1] == 208
    assert not idx.x_lo[:, 200:].any()
    ids, _ = idx.search(wide[:5], k=1, c=8)
    assert ids[:, 0].tolist() == list(range(5))


def test_rejected_options():
    x = np.zeros((64, 8), np.float32)
    with pytest.raises(ValueError, match="int8 scan requires mode='binned'"):
        FusedScanIndex(x, mode="shifted", scan_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        FusedScanIndex(x, mode="ring", device="cpu")
    idx = FusedScanIndex(x, device="cpu")
    with pytest.raises(ValueError):
        idx.candidates(np.zeros((2, 8), np.float32), merge="fast")
