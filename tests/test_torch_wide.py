"""The port at the widths the JAX kernels take and the port's kernels did not:
reduced widths above 128 (the unreduced high-dimensional path) and widths
that are no kernel width, on the CPU through the kernels' plain versions,
held against the JAX package's Pallas kernels run as its own tests run them
(interpret mode), on the same numpy-seeded inputs:

* ``binned_scan`` at d = 24, 100, 160 and 200, l2 and ip, packed and
  unpacked, at tests/test_torch_scan_epilogues.py's sizes;
* ``GatedScanIndex`` at d_lo = 160 at tests/test_gated.py's sizes (4,096
  rows, 32 clusters, fine 4, m 16, sub 64, chunk 512, tq 64): the index
  carried over from JAX and the port's own constructor;
* ``FusedScanIndex(mode="shifted")`` at d_lo = 160 at
  tests/test_fused_scan.py's sizes (2,048 rows, bins of 32, chunk 256);
* the route functions above d = 128.

Tolerances: ids equal but for near-ties counted by ``scan_agreement`` /
``gated_agreement`` (the port's score at its row within 1e-5 of the largest
|value|, plus one key quantum of a packed key, of JAX's minimum), at most
two a call; values within 5e-3 of the largest |value| of the call; index
searches equal on at least 99 % of rows and R@10 within 0.005. The sums are
fp32 in both packages, in another order. The CUDA kernels at these widths
are held against the plain versions on the card
(tests/test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.io.synthetic import SyntheticSpec, make_synthetic
from gbnns_tpu.kernels import scan_topk_pallas as jst
from gbnns_tpu.search.gated import GatedScanIndex as JaxGated
from gbnns_tpu_torch.eval.recall import recall_at_k
from gbnns_tpu_torch.kernels import scan_topk as st
from gbnns_tpu_torch.search.gated import GatedScanIndex

VALUE_TOL = 5e-3
MAX_NEAR_TIES = 2
GATED_GEOMETRY = dict(fine=4, m=16, sub=64, chunk=512, tq=64)


def _value_scale(rv: np.ndarray) -> float:
    finite = rv[np.isfinite(rv)]
    return float(np.abs(finite).max()) if finite.size else 1.0


@pytest.mark.parametrize("d", [24, 100, 160, 200])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("packed", [False, True])
def test_binned_scan_matches_pallas_at_any_width(d, metric, packed):
    """The Pallas scan's unprescaled epilogue (JAX's no-keyword call but
    for the metric and the key) at a width past 128 or off the kernel
    widths; the port's card wrapper pads such a width to scan_width(d)."""
    rng = np.random.default_rng(d + 3 * packed + (metric == "ip"))
    n, B = 1024, 48
    x = (rng.normal(size=(n, d)) * 2.0 - 0.5).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    xr = torch.from_numpy(x).to(torch.bfloat16)
    add = ((xr.float() ** 2).sum(-1).numpy() if metric == "l2"
           else np.zeros(n, np.float32))
    add[-24:] = np.inf
    kw = dict(metric=metric, bin_size=128, chunk=512, tq=64, packed=packed)
    rv, ri = (np.asarray(a) for a in jst.binned_scan(
        jnp.asarray(q), jnp.asarray(x, dtype=jnp.bfloat16),
        jnp.asarray(add), interpret=True, **kw))
    args = (torch.from_numpy(q), xr, torch.from_numpy(add))
    got = st.binned_scan(*args, **kw)
    assert got[0].shape == rv.shape == (B, n // 128)
    ref = (torch.from_numpy(rv.copy()), torch.from_numpy(ri.copy()))
    kw.pop("tq")
    rep = st.scan_agreement(got, ref, *args, rtol=1e-5, **kw)
    assert rep["ok"], rep
    assert rep["id_mismatches"] <= MAX_NEAR_TIES, rep
    assert rep["max_abs_err"] <= VALUE_TOL * _value_scale(rv), rep


@pytest.fixture(scope="module")
def gated_corpus():
    data = make_synthetic(SyntheticSpec(n_base=4096, n_query=256, dim=160,
                                        n_clusters=32, seed=11))
    base, query = data["base"], data["query"]
    d2 = ((query[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10].astype(np.int32)
    return base, query, gt


@pytest.fixture(scope="module")
def jax_gated(gated_corpus):
    return JaxGated(gated_corpus[0], kmeans_sample=None, **GATED_GEOMETRY)


def test_gated_scan_matches_pallas_at_160():
    """T4's plain version against the Pallas gated scan at d = 160, a
    random tile mask."""
    rng = np.random.default_rng(16)
    n_pad, d, B = 4096, 160, 256
    x = -2.0 * rng.normal(size=(n_pad, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    add = ((x / 2.0) ** 2).sum(-1).astype(np.float32)
    add[-70:] = np.inf
    keep = (rng.random(n_pad // 512 * B // 64) < 0.5).astype(np.int32)
    kw = {k: v for k, v in GATED_GEOMETRY.items() if k != "tq"}
    rv, ri = jst.gated_topm_scan(jnp.asarray(q),
                                 jnp.asarray(x, dtype=jnp.bfloat16),
                                 jnp.asarray(add), jnp.asarray(keep), tq=64,
                                 interpret=True, **kw)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    qt, at = torch.from_numpy(q), torch.from_numpy(add)
    got = st.gated_topm_scan(qt, xt, at, torch.from_numpy(keep), tq=64, **kw)
    rv, ri = np.array(rv), np.array(ri)
    ref = (torch.from_numpy(rv), torch.from_numpy(ri))
    rep = st.gated_agreement(got, ref, qt, xt, at, fine=4, sub=64, chunk=512)
    assert rep["ok"], rep
    assert rep["id_mismatches"] <= MAX_NEAR_TIES, rep
    assert rep["max_abs_err"] <= VALUE_TOL * _value_scale(rv), rep


@pytest.mark.parametrize("probes", [1, 4, 32])
def test_gated_index_from_jax_matches_at_160(gated_corpus, jax_gated,
                                             probes):
    base, query, gt = gated_corpus
    mine = GatedScanIndex.from_jax(jax_gated, device="cpu")
    assert mine.x_lo.shape[1] == 160 and mine.stats == jax_gated.stats
    ri = np.asarray(jax_gated.search(query, k=10, c=64, probes=probes,
                                     merge="exact")[0])
    mi = mine.search(query, k=10, c=64, probes=probes)[0].numpy()
    assert (mi == ri).all(axis=1).mean() >= 0.99
    assert abs(recall_at_k(mi, gt, 10) - recall_at_k(ri, gt, 10)) <= 0.005


def test_gated_index_own_constructor_at_160(gated_corpus, jax_gated):
    """The port's constructor at d_lo = 160 (a multiple of 16 past 128: no
    padding column) searches as the JAX index does."""
    base, query, gt = gated_corpus
    own = GatedScanIndex(base, kmeans_sample=None, device="cpu",
                         **GATED_GEOMETRY)
    assert own.x_lo.shape == (own.n_chunks * 512, 160)
    assert own.stats == jax_gated.stats
    for probes in (4, 32):
        ri = np.asarray(jax_gated.search(query, k=10, c=64, probes=probes,
                                         merge="exact")[0])
        mi = own.search(query, k=10, c=64, probes=probes)[0].numpy()
        assert abs(recall_at_k(mi, gt, 10)
                   - recall_at_k(ri, gt, 10)) <= 0.005, probes


def test_gated_index_pads_to_scan_width():
    """A reduced width past 128 that is not a multiple of 16 is stored
    padded to scan_width (exact), as SCAN_WIDTHS pad below 128."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(2048, 136)).astype(np.float32)
    idx = GatedScanIndex(base, kmeans_sample=None, device="cpu",
                         **GATED_GEOMETRY)
    assert idx.x_lo.shape[1] == st.scan_width(136) == 144
    assert not idx.x_lo[:, 136:].float().any()
    ids = idx.search(base[:64], k=1, probes=8)[0].numpy()
    assert (ids[:, 0] == np.arange(64)).mean() >= 0.95


@pytest.mark.parametrize("metric", ["l2", "angular"])
def test_shifted_index_matches_jax_at_160(metric):
    data = make_synthetic(SyntheticSpec(n_base=2048, n_query=128, dim=160,
                                        n_clusters=32, seed=7))
    base, query = data["base"], data["query"]
    if metric == "angular":
        base = base / np.linalg.norm(base, axis=1, keepdims=True)
        query = query / np.linalg.norm(query, axis=1, keepdims=True)
        score = -(query @ base.T)
    else:
        score = ((query[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(score, axis=1, kind="stable")[:, :10].astype(np.int32)
    kw = dict(metric=metric, bin_size=32, chunk=256, tq=64, mode="shifted")
    ref = jst.FusedScanIndex(base, **kw)
    mine = st.FusedScanIndex(base, device="cpu", **kw)
    assert mine.x_aug.shape[1] == 164
    np.testing.assert_array_equal(
        mine.x_aug.float().numpy()[:, :ref.x_aug.shape[1]],
        np.asarray(ref.x_aug.astype(jnp.float32)))
    q_aug = mine.shifted_queries(torch.from_numpy(query))
    assert st.shifted_cores(mine.x_aug.dtype, 164, mine.bin_size) == "tensor"
    # the scans: the port's plain T3 against the Pallas kernel
    jq = jnp.asarray(q_aug.numpy()[:, :ref.x_aug.shape[1]])
    rv, ri = (np.asarray(a) for a in jst.shifted_scan(
        jq, ref.x_aug, bin_size=32, chunk=256, tq=64, interpret=True))
    got = st.shifted_scan(q_aug, mine.x_aug, bin_size=32)
    refs = (torch.from_numpy(rv.copy()), torch.from_numpy(ri.copy()))
    rep = st.shifted_agreement(got, refs, q_aug, mine.x_aug, bin_size=32)
    assert rep["ok"], rep
    assert rep["id_mismatches"] <= MAX_NEAR_TIES, rep
    assert rep["max_abs_err"] <= VALUE_TOL * _value_scale(rv), rep
    ids = mine.search(query, k=10, c=64)[0].numpy()
    ref_ids = np.asarray(ref.search(query, k=10, c=64)[0])
    assert (ids == ref_ids).all(axis=1).mean() >= 0.99
    assert abs(recall_at_k(ids, gt, 10) - recall_at_k(ref_ids, gt, 10)) \
        <= 0.005


@pytest.mark.parametrize("kind", ["bfloat16", "float16", "int8"])
@pytest.mark.parametrize("d", [136, 144, 160, 288, 300, 960, 1024])
def test_wide_scans_take_the_tensor_cores(kind, d):
    assert st.scan_cores(kind, d, 1024) == "tensor"
    assert st.scan_cores(kind, d, 16) == "tensor"
    assert st.scan_cores(kind, d, 8) == "cuda"       # bins off the row tile
    assert st.scan_cores(torch.float32, d, 1024) == "cuda"


@pytest.mark.parametrize("d_aug,width", [(164, 164), (268, 272),
                                         (304, 304), (964, 968),
                                         (1028, 1032)])
def test_wide_shifted_routes(d_aug, width):
    """Past 264, T3 runs rows of a multiple of 8 columns on every route
    (``shifted_scan`` pads to ``shifted_width``)."""
    for kind in (torch.bfloat16, torch.float16):
        assert st.shifted_cores(kind, d_aug) == "tensor"
    assert st.shifted_cores(torch.float32, d_aug) == "cuda"
    assert st.shifted_cores(torch.bfloat16, d_aug, bin_size=8) == "cuda"
    assert st.shifted_width(d_aug) == width


@pytest.mark.parametrize("d", [144, 160, 960])
def test_wide_gated_routes_take_the_cuda_cores(d):
    for kind in (torch.bfloat16, torch.float16, torch.float32):
        assert st.gated_cores(kind, d, fine=32, tq=512) == "cuda"
    with pytest.raises(ValueError, match="tensor-core kernel"):
        st.gated_topm_scan(torch.zeros((64, d)), torch.zeros((512, d)),
                           torch.zeros(512), torch.ones(1, dtype=torch.int32),
                           fine=32, m=4, sub=512, chunk=512, tq=64,
                           cores="tensor")


@pytest.mark.parametrize("d,width", [(24, 32), (100, 128), (128, 128),
                                     (136, 144), (200, 208), (960, 960)])
def test_scan_width_pads_to_a_kernel_width(d, width):
    assert st.scan_width(d) == width
