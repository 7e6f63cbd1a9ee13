"""The shifted-key scan (T3) and ``FusedScanIndex(mode="shifted")``: the port
(on the CPU, through ``shifted_scan_plain``) against the JAX package's
(Pallas in interpret mode, as its own tests run it), on inputs made with
numpy from a seed.

Tolerances: ``augment_corpus`` is bit for bit (numpy on both sides, and
torch's cast to bfloat16 rounds to nearest even as ml_dtypes does);
``augment_queries`` within 1e-6 relative (the two frameworks sum the norm
in another order, so its lo part carries the last bit); bin winners and
candidates equal except at near-ties, where the plain score of the other
package's row lies within ``TIE_RTOL`` of the largest score (two sums in
another order, plus the key's quantum of 2^(log2 bin - 23) relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.kernels import scan_topk_pallas as jst
from gbnns_tpu_torch.eval.recall import recall_at_k
from gbnns_tpu_torch.kernels import scan_topk as st

TIE_RTOL = 1e-5


def _mk(n=2048, d=32, B=64, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 2.0 - 0.5).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    return x, q


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_augment_corpus_is_bit_exact(metric):
    x, _ = _mk()
    x[1900:] = 0.0                    # padding rows past n
    ref = jst.augment_corpus(x, 1900, metric)
    mine = st.augment_corpus(x, 1900, metric)
    assert mine.dtype == np.float32 and mine.shape == ref.shape
    np.testing.assert_array_equal(mine.view(np.int32), ref.view(np.int32))
    assert np.isinf(mine[1900:, 32]).all() and not mine[1900:, :32].any()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_augment_queries_agree(metric):
    _, q = _mk(seed=1)
    ref = np.asarray(jst.augment_queries(jnp.asarray(q), metric, 3.25))
    mine = st.augment_queries(torch.from_numpy(q), metric, 3.25).numpy()
    assert mine.shape == ref.shape
    np.testing.assert_array_equal(mine[:, :32], q)   # unrounded queries
    if metric == "l2":
        np.testing.assert_array_equal(mine[:, 32:34], 1.0)
        # the norm as hi + lo: its split may move by the last bit
        np.testing.assert_allclose(mine[:, 34] + mine[:, 35],
                                   ref[:, 34] + ref[:, 35], rtol=1e-6)
        hi = torch.from_numpy(mine[:, 34]).to(torch.bfloat16).float()
        np.testing.assert_array_equal(hi.numpy(), mine[:, 34])
    else:
        np.testing.assert_allclose(mine[:, 32], ref[:, 32], rtol=1e-6)


def _scores(q_aug, x_aug, dtype):
    """The exact (float64) scores of the augmented operands in ``dtype``."""
    qd = torch.from_numpy(q_aug).to(dtype).double()
    xd = torch.from_numpy(x_aug).to(dtype).double()
    return (qd @ xd.T).numpy()                                   # (B, n)


def _winners_agree(mine_ids, ref_ids, s):
    """Bin winners equal, or a near-tie: the exact score of the other row
    within TIE_RTOL of the largest finite score of the bin's min."""
    tol = TIE_RTOL * np.abs(s[np.isfinite(s)]).max()
    miss = np.nonzero(mine_ids != ref_ids)
    got = s[miss[0], mine_ids[miss]]
    want = s[miss[0], ref_ids[miss]]
    assert (np.abs(got - want) <= tol).all(), (got, want)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shifted_scan_plain_matches_pallas(metric, dtype):
    x, q = _mk()
    n = 2000
    x_aug = jst.augment_corpus(x, n, metric)
    q_aug = np.array(jst.augment_queries(jnp.asarray(q), metric, 8.0))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rv, ri = jst.shifted_scan(jnp.asarray(q_aug), jnp.asarray(x_aug, jdt),
                              bin_size=128, chunk=512, tq=64, interpret=True)
    mv, mi = st.shifted_scan(torch.from_numpy(q_aug),
                             torch.from_numpy(x_aug).to(dtype), bin_size=128)
    assert mv.shape == mi.shape == (64, 16)
    assert mv.dtype == torch.float32 and mi.dtype == torch.int32
    s = _scores(q_aug, x_aug, dtype)
    _winners_agree(mi.numpy(), np.asarray(ri), s)
    # the last bin holds the padding rows 2000..2047; they never win
    assert (mi.numpy() < n).all()
    same = mi.numpy() == np.asarray(ri)
    np.testing.assert_allclose(mv.numpy()[same], np.asarray(rv)[same],
                               rtol=2.0 ** -15, atol=1e-4)


def test_shifted_keys_use_the_raw_bits():
    """Negative scores keep the raw-bits order: the Pallas key has no sign
    flip, so -1.0 (0xBF800000) beats -2.0 (0xC0000000) within a bin."""
    x_aug = torch.tensor([[-2.0], [-1.0], [1.0], [3.0]])
    q_aug = torch.tensor([[1.0]])
    vals, ids = st.shifted_scan_plain(q_aug, x_aug, bin_size=4)
    assert ids.tolist() == [[1]] and vals.tolist() == [[-1.0]]


def test_shifted_scan_refusals_match_jax():
    x_aug = torch.zeros(64, 36)
    q_aug = torch.zeros(2, 36)
    with pytest.raises(ValueError, match="power-of-two"):
        st.shifted_scan(q_aug, x_aug, bin_size=24)
    with pytest.raises(ValueError, match="augment mismatch"):
        st.shifted_scan(q_aug[:, :33], x_aug, bin_size=16)
    with pytest.raises(ValueError, match="augment mismatch"):
        jst.shifted_scan(jnp.zeros((2, 33)), jnp.zeros((64, 36)),
                         bin_size=16, chunk=64, interpret=True)
    with pytest.raises(TypeError, match="int8"):
        st.shifted_scan(q_aug, x_aug.to(torch.int8), bin_size=16)


def _candidates_agree(mine, ref, scores):
    """Candidate lists equal as sets, except at near-ties: an id in only
    one list scores within TIE_RTOL (of the largest score) of the other
    list's worst kept score. Returns the share of rows with equal lists."""
    tol = TIE_RTOL * np.abs(scores[np.isfinite(scores)]).max()
    for r in range(mine.shape[0]):
        a, b = set(mine[r].tolist()), set(ref[r].tolist())
        if a == b:
            continue
        edge = max(scores[r, list(a)].max(), scores[r, list(b)].max())
        for i in a ^ b:
            assert scores[r, i] >= edge - tol, (r, i)
    return (mine == ref).all(axis=1).mean()


@pytest.mark.parametrize("metric", ["l2", "angular"])
def test_shifted_index_matches_jax(fixture_data, fixture_gt, metric):
    base, query = fixture_data
    gt = fixture_gt
    if metric == "angular":
        base = base / np.linalg.norm(base, axis=1, keepdims=True)
        query = query / np.linalg.norm(query, axis=1, keepdims=True)
        gt = np.argsort(-(query @ base.T), axis=1,
                        kind="stable")[:, :10].astype(np.int32)
    kw = dict(metric=metric, bin_size=32, chunk=256, tq=64, mode="shifted")
    ref = jst.FusedScanIndex(base, **kw)
    mine = st.FusedScanIndex(base, device="cpu", **kw)
    assert mine.bin_size == ref.bin_size and mine.max_norm == ref.max_norm
    np.testing.assert_array_equal(
        mine.x_aug.float().numpy()[:, :ref.x_aug.shape[1]],
        np.asarray(ref.x_aug.astype(jnp.float32)))
    rc = np.asarray(ref.candidates(query, c=64))
    mc = mine.candidates(query, c=64).numpy()
    assert mc.shape == rc.shape == (query.shape[0], 64)
    q_aug = mine.shifted_queries(torch.from_numpy(query)).numpy()
    s = _scores(q_aug, mine.x_aug.float().numpy(), torch.bfloat16)
    assert _candidates_agree(mc, rc, s) >= 0.95
    ids = mine.search(query, k=10, c=64)[0].numpy()
    ref_ids = np.asarray(ref.search(query, k=10, c=64)[0])
    assert recall_at_k(ids, gt, 10) > 0.9
    assert abs(recall_at_k(ids, gt, 10) - recall_at_k(ref_ids, gt, 10)) \
        <= 0.005


def test_shifted_index_refusals_match_jax():
    x = np.zeros((64, 8), np.float32)
    for cls, kw in ((jst.FusedScanIndex, {}),
                    (st.FusedScanIndex, dict(device="cpu"))):
        with pytest.raises(ValueError, match="int8 scan requires"):
            cls(x, scan_dtype="int8", mode="shifted", **kw)
        with pytest.raises(ValueError, match="unknown mode"):
            cls(x, mode="ring", **kw)


@pytest.mark.parametrize("merge", [None, "pallas", "exact", "approx"])
def test_shifted_index_launches_no_merge(merge):
    """Every merge gives the exact top-c on the shifted path: one scan, no
    K2 (on the CPU the wrappers count nothing)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1500, 24)).astype(np.float32)
    idx = st.FusedScanIndex(x, mode="shifted", scan_dtype="float32",
                            chunk=512, device="cpu")
    assert idx.x_aug.shape == (1536, 36) and idx.x_aug.dtype == torch.float32
    cand = idx.candidates(x[:20], c=16, merge=merge)
    assert cand[:, 0].tolist() == list(range(20))
    ref = idx.candidates(x[:20], c=16, merge="exact")
    assert torch.equal(cand, ref)
