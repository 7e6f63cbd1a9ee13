"""The IVF index (``search/ivf.py``) against the JAX package's on the same
numpy inputs (JAX on the CPU).

Tolerances:
  * given JAX's centroids (``centroids=``), ``block_ids``, ``spill_ids`` and
    ``stats`` are equal: the layout is the same numpy in both packages, and
    the nearest-centroid assignment of these inputs has no fp32 near-tie;
  * given only the seed, the centroids agree within 1e-4 (the port's
    k-means draws its sample and start as JAX's; sums in another order);
  * search ids are equal except at counted near-ties (the two ids' exact
    distances within 1e-5 relative of each other), no more than 1 % of the
    rows; distances agree within 1e-5 relative to the row's largest.
The cases cover l2 and ip, a bf16 and an f32 scan, a ragged query count
(173) and a bucket ``slack`` of 0.25 that overflows buckets, as
``tests/test_ivf.py`` does for the JAX index.
"""

import jax
import numpy as np
import pytest
import torch

from gbnns_tpu.search.ivf import IVFIndex as JaxIVF
from gbnns_tpu_torch.search.ivf import IVFIndex, ivf_search

NQ = 173


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n, d, d_lo = 4096, 24, 8
    cents = rng.normal(size=(48, d)) * 3.0
    base = (cents[rng.integers(0, 48, n)]
            + rng.normal(size=(n, d))).astype(np.float32)
    query = (cents[rng.integers(0, 48, NQ)]
             + rng.normal(size=(NQ, d))).astype(np.float32)
    proj = np.linalg.qr(rng.normal(size=(d, d)))[0][:, :d_lo]
    return base, query, (base @ proj).astype(np.float32), \
        (query @ proj).astype(np.float32)


_JAX_DTYPES = {"bfloat16": jax.numpy.bfloat16, "float32": jax.numpy.float32}
_indexes: dict = {}


def _pair(data, metric, dtype):
    """JAX's index and the port's over JAX's centroids, built once."""
    key = (metric, dtype)
    if key not in _indexes:
        base, _, lo, _ = data
        ref = JaxIVF.build(base, lo, metric=metric, seed=0,
                           scan_dtype=_JAX_DTYPES[dtype])
        mine = IVFIndex.build(base, lo, metric=metric, scan_dtype=dtype,
                              centroids=np.asarray(ref.centroids),
                              device="cpu")
        _indexes[key] = (ref, mine)
    return _indexes[key]


def _agree(ref, mine, tol=1e-5):
    """Ids equal but for counted near-ties; distances close. Returns the
    number of rows whose ids differ."""
    ji, jd = (np.asarray(a) for a in ref)
    ti, td = (a.numpy() for a in mine)
    scale = np.abs(jd).max(axis=1, keepdims=True) + 1e-30
    np.testing.assert_array_less(np.abs(td - jd) / scale, tol)
    rows = np.nonzero((ji != ti).any(axis=1))[0]
    for r in rows:
        for pos in np.nonzero(ji[r] != ti[r])[0]:
            assert abs(jd[r, pos] - td[r, pos]) <= tol * scale[r, 0], (r, pos)
    assert len(rows) <= 0.01 * ji.shape[0], len(rows)
    return len(rows)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layout_equals_jax_given_its_centroids(data, metric, dtype):
    ref, mine = _pair(data, metric, dtype)
    np.testing.assert_array_equal(mine.block_ids.numpy(),
                                  np.asarray(ref.block_ids))
    np.testing.assert_array_equal(mine.spill_ids.numpy(),
                                  np.asarray(ref.spill_ids))
    assert mine.stats == ref.stats
    assert mine.blocks_lo.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        mine.blocks_lo.float().numpy(),
        np.asarray(ref.blocks_lo.astype(jax.numpy.float32)))
    np.testing.assert_allclose(mine.block_sq.numpy(),
                               np.asarray(ref.block_sq), rtol=1e-6)


def test_centroids_from_the_seed_agree_with_jax(data):
    base, _, lo, _ = data
    ref = JaxIVF.build(base, lo, seed=3)
    mine = IVFIndex.build(base, lo, seed=3, device="cpu")
    np.testing.assert_allclose(mine.centroids.numpy(),
                               np.asarray(ref.centroids), atol=1e-4)
    assert mine.stats["ncent"] == ref.stats["ncent"] == 256
    assert mine.stats["cap"] == ref.stats["cap"]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("slack", [2.0, 0.25])
def test_search_agrees_with_jax(data, metric, dtype, slack):
    _, query, _, qlo = data
    ref, mine = _pair(data, metric, dtype)
    # slack 0.25 leaves a bucket fewer slots than its clusters' pairs
    assert mine.qslots_for(NQ, 8, slack) == ref.qslots_for(NQ, 8, slack)
    got = mine.search(query, qlo, k=10, c=32, probes=8, slack=slack)
    want = ref.search(query, qlo, k=10, c=32, probes=8, slack=slack)
    assert got[0].dtype == torch.int32 and got[0].shape == (NQ, 10)
    _agree(want, got)


def test_overflow_drops_pairs_and_costs_recall(data):
    """With buckets far too small some pairs go unscanned: the answers
    differ from the roomy search's (and still match JAX's)."""
    _, query, _, qlo = data
    _, mine = _pair(data, "l2", "float32")
    roomy = mine.search(query, qlo, k=10, c=32, probes=8, slack=4.0)[0]
    tight = mine.search(query, qlo, k=10, c=32, probes=8, slack=0.25)[0]
    assert (roomy != tight).any()


def test_full_space_search_and_cprobe_agree_with_jax(data):
    """No reduced space (the index scans the full 24 dimensions) and an
    explicit cprobe."""
    base, query, _, _ = data
    ref = JaxIVF.build(base, seed=0)
    mine = IVFIndex.build(base, centroids=np.asarray(ref.centroids),
                          device="cpu")
    _agree(ref.search(query, k=5, c=16, probes=4, cprobe=8),
           mine.search(query, k=5, c=16, probes=4, cprobe=8))


def test_ivf_search_rejects_an_unknown_metric(data):
    _, mine = _pair(data, "l2", "float32")
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="unknown metric"):
        ivf_search(q, torch.zeros((2, 24)), mine.centroids, mine.cent_sq,
                   mine.block_ids, mine.blocks_lo, mine.block_sq,
                   mine.spill_ids, mine.spill_lo, mine.spill_sq,
                   mine.base_full, mine.base_sq, k=1, c=4, probes=2,
                   cprobe=2, qslots=8, metric="cosine")


def test_build_rejects_an_int8_scan(data):
    base, _, lo, _ = data
    with pytest.raises(ValueError, match="scan_dtype"):
        IVFIndex.build(base, lo, scan_dtype="int8", device="cpu")
