"""The cluster-gated scan: the port (on the CPU, through the plain version of
T4) against the JAX package (the Pallas kernel in interpret mode), at
tests/test_gated.py's shapes: 4,096 x 32, 32 clusters, seed 11; fine 4,
m 16, sub 64, chunk 512, tq 64.

Tolerances: winners' values within 1e-5 of the largest value plus one key
quantum (the two packages sum the dots in another order), ids equal except
at such near-ties; searches equal on at least 99 % of rows and R@10 within
0.005; the port's own constructor draws the JAX centroids (within 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.build.kmeans import kmeans_assign as jax_assign
from gbnns_tpu.io.synthetic import SyntheticSpec, make_synthetic
from gbnns_tpu.kernels.scan_topk_pallas import gated_topm_scan as jax_gated
from gbnns_tpu.search import gated as jax_gated_mod
from gbnns_tpu.search.gated import GatedScanIndex as JaxGated
from gbnns_tpu_torch.build.kmeans import kmeans_assign
from gbnns_tpu_torch.eval.recall import recall_at_k
from gbnns_tpu_torch.kernels import scan_topk as st
from gbnns_tpu_torch.search.gated import GatedScanIndex

GEOMETRY = dict(fine=4, m=16, sub=64, chunk=512, tq=64)


@pytest.fixture(scope="module")
def corpus():
    data = make_synthetic(SyntheticSpec(n_base=4096, n_query=256, dim=32,
                                        n_clusters=32, seed=11))
    base, query = data["base"], data["query"]
    d2 = ((query[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10].astype(np.int32)
    return base, query, gt


@pytest.fixture(scope="module")
def jidx(corpus):
    return JaxGated(corpus[0], kmeans_sample=None, **GEOMETRY)


@pytest.fixture(scope="module")
def own(corpus):
    return GatedScanIndex(corpus[0], kmeans_sample=None, device="cpu",
                          **GEOMETRY)


def _scan_inputs(mask_kind, seed=3, n_pad=4096, d=32, B=256):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_pad, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    add = (x ** 2).sum(-1).astype(np.float32)
    add[-70:] = np.inf                                  # padding rows
    cells = n_pad // GEOMETRY["chunk"] * B // GEOMETRY["tq"]
    keep = {"random": rng.random(cells) < 0.5, "all": np.ones(cells),
            "none": np.zeros(cells)}[mask_kind].astype(np.int32)
    return q, -2.0 * x, add, keep


@pytest.mark.parametrize("mask_kind,dtype", [("random", "bfloat16"),
                                             ("all", "float32"),
                                             ("random", "float16"),
                                             ("none", "bfloat16")])
def test_plain_scan_matches_jax_interpret(mask_kind, dtype):
    q, x, add, keep = _scan_inputs(mask_kind)
    kw = dict(GEOMETRY)
    kw.pop("tq")
    rv, ri = jax_gated(jnp.asarray(q), jnp.asarray(x, dtype=dtype),
                       jnp.asarray(add), jnp.asarray(keep), tq=64,
                       interpret=True, **kw)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qt, at = torch.from_numpy(q), torch.from_numpy(add)
    before = dict(st.launches)
    got = st.gated_topm_scan(qt, xt, at, torch.from_numpy(keep), tq=64, **kw)
    assert st.launches == before                     # the CPU launches none
    ref = (torch.from_numpy(np.array(rv)), torch.from_numpy(np.array(ri)))
    assert got[0].shape == ref[0].shape == (256, 16 * 8)
    rep = st.gated_agreement(got, ref, qt, xt, at, fine=4, sub=64,
                             chunk=512, rtol=1e-5)
    assert rep["ok"], rep
    skipped = ref[1] < 0
    assert torch.equal(got[1] < 0, skipped)
    assert torch.isinf(got[0][skipped]).all()
    if mask_kind == "none":
        assert skipped.all()
    else:
        assert (~skipped).any()


def test_plain_scan_is_the_two_level_selection():
    """Each kept chunk's m winners are the m best fine bins of that chunk,
    each bin's best row, against a float64 oracle: equal except where two
    scores lie within two key quanta (2^(7 - 22) relative at sub 128)."""
    rng = np.random.default_rng(8)
    n_pad, d, B = 1024, 16, 64
    x = rng.normal(size=(n_pad, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    add = np.zeros(n_pad, np.float32)
    keep = np.ones(2, np.int32)
    vals, ids = st.gated_topm_scan_plain(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(add),
        torch.from_numpy(keep), fine=8, m=4, sub=128, chunk=512, tq=64)
    s = x.astype(np.float64) @ q.astype(np.float64).T       # (n_pad, B)
    cols = np.arange(B)[:, None]
    for j in range(2):
        bins = s[j * 512:(j + 1) * 512].reshape(64, 8, B)
        best_row = bins.argmin(1) + 8 * np.arange(64)[:, None] + 512 * j
        best = bins.min(1)                                   # (64, B)
        top = np.argsort(best, axis=0, kind="stable")[:4]
        want = np.take_along_axis(best_row, top, 0).T        # (B, 4)
        got = ids[:, 4 * j:4 * j + 4].numpy()
        gap = np.abs(s[got, cols] - s[want, cols])
        assert (gap <= 2.0 ** -15 * np.abs(s[want, cols])).all()
        assert (got == want).mean() >= 0.99
        np.testing.assert_allclose(vals[:, 4 * j:4 * j + 4].numpy(),
                                   s[got, cols], rtol=2.0 ** -15)


@pytest.mark.parametrize("probes", [1, 4, 32])
def test_from_jax_searches_match(corpus, jidx, probes):
    base, query, gt = corpus
    mine = GatedScanIndex.from_jax(jidx, device="cpu")
    assert mine.stats == jidx.stats
    order, mask, tq = mine.plan(query, probes=probes)
    jorder, jmask = jax_gated_mod._plan_queries(
        jnp.asarray(query), jidx.cent, jidx.cent_sq, jidx.neighbors,
        jidx.chunk_mask, jidx.chain_rank, n_chunks=jidx.n_chunks, tq=tq,
        probes=probes)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    ri, _, rk = jidx.search(query, k=10, c=64, probes=probes, merge="exact",
                            return_kept_frac=True)
    mi, md, mk = mine.search(query, k=10, c=64, probes=probes,
                             return_kept_frac=True)
    assert mk == rk
    ri = np.asarray(ri)
    assert (mi.numpy() == ri).all(axis=1).mean() >= 0.99
    assert abs(recall_at_k(mi.numpy(), gt, 10)
               - recall_at_k(ri, gt, 10)) <= 0.005
    assert (np.diff(md.numpy(), axis=1) >= -1e-5).all()


@pytest.mark.parametrize("scan_dtype", ["float16", "float32"])
def test_float_kinds_match_jax(corpus, scan_dtype):
    base, query, gt = corpus
    ref = JaxGated(base, kmeans_sample=None,
                   scan_dtype=getattr(jnp, scan_dtype), **GEOMETRY)
    mine = GatedScanIndex.from_jax(ref, device="cpu")
    assert mine.x_lo.dtype == getattr(torch, scan_dtype)
    ri = np.asarray(ref.search(query, k=10, c=64, probes=4)[0])
    mi = mine.search(query, k=10, c=64, probes=4)[0].numpy()
    assert (mi == ri).all(axis=1).mean() >= 0.99
    assert abs(recall_at_k(mi, gt, 10) - recall_at_k(ri, gt, 10)) <= 0.005


def test_own_constructor_matches_jax(corpus, jidx, own):
    base, query, gt = corpus
    assert own.stats == jidx.stats
    np.testing.assert_allclose(own.cent.numpy(), np.asarray(jidx.cent),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(own.chain_rank.numpy(),
                                  np.asarray(jidx.chain_rank))
    assign = jax_assign(base, np.asarray(jidx.cent))
    mine_assign = kmeans_assign(base, own.cent.numpy(), device="cpu")
    assert (mine_assign == assign).mean() >= 0.999
    assert (own.perm.numpy() == np.asarray(jidx.perm)).mean() >= 0.999
    for probes in (1, 4, 32):
        ri = np.asarray(jidx.search(query, k=10, c=64, probes=probes,
                                    merge="exact")[0])
        mi = own.search(query, k=10, c=64, probes=probes)[0].numpy()
        assert abs(recall_at_k(mi, gt, 10)
                   - recall_at_k(ri, gt, 10)) <= 0.005, probes


def test_probes_monotone_recall_and_input_order(corpus, own):
    """As tests/test_gated.py asks of the JAX index."""
    base, query, gt = corpus
    recalls = [recall_at_k(own.search(query, k=10, c=64, probes=p)[0].numpy(),
                           gt, 10) for p in (1, 4, 32)]
    assert recalls[0] <= recalls[1] + 0.02 <= recalls[2] + 0.04, recalls
    assert recalls[-1] >= 0.93
    ids_all = own.search(query, k=10, c=64, probes=8)[0].numpy()
    ids_head = own.search(query[:64], k=10, c=64, probes=8)[0].numpy()
    assert (ids_all[:64, 0] == ids_head[:, 0]).mean() >= 0.95
    assert (ids_all >= -1).all() and (ids_all < base.shape[0]).all()


def test_metric_angular_and_ip_refusal(corpus):
    base, query, _ = corpus
    bn = base / np.linalg.norm(base, axis=1, keepdims=True)
    qn = query / np.linalg.norm(query, axis=1, keepdims=True)
    kw = dict(metric="angular", kmeans_sample=None, **GEOMETRY)
    ref = JaxGated(bn, **kw)
    mine = GatedScanIndex(bn, device="cpu", **kw)
    gt = np.argsort(-(qn @ bn.T), axis=1, kind="stable")[:, :10]
    ri = np.asarray(ref.search(qn, k=10, c=64, probes=8, merge="exact")[0])
    mi = mine.search(qn, k=10, c=64, probes=8)[0].numpy()
    r_mine = recall_at_k(mi, gt, 10)
    assert r_mine >= 0.85
    assert abs(r_mine - recall_at_k(ri, gt, 10)) <= 0.005
    with pytest.raises(ValueError, match="ip"):
        GatedScanIndex(bn, metric="ip", chunk=512, kmeans_sample=None,
                       device="cpu")


def test_gated_scan_checks_its_arguments():
    q, x, add, keep = (torch.from_numpy(a) for a in _scan_inputs("all"))
    kw = dict(GEOMETRY)
    for bad, err, match in (
            (dict(fine=3), ValueError, "fine must be a power of two"),
            (dict(m=12), ValueError, "m must be a power of two"),
            (dict(m=256), ValueError, "fine bins per chunk"),
            (dict(tq=96), ValueError, "pad B")):
        with pytest.raises(err, match=match):
            st.gated_topm_scan(q, x, add, keep, **{**kw, **bad})
    with pytest.raises(ValueError, match="chunk / fine"):   # 96 fine bins
        st.gated_topm_scan(q, x[:3840], add[:3840], keep,
                           **{**kw, "chunk": 384, "sub": 128})
    with pytest.raises(TypeError, match="int8"):
        st.gated_topm_scan(q.to(torch.int8), x.to(torch.int8), add, keep,
                           **kw)
    with pytest.raises(ValueError, match="tile_mask"):
        st.gated_topm_scan(q, x, add, keep[:-1], **kw)


def test_wrappers_never_fall_back():
    """On a device other than the CPU a wrapper launches its kernel or
    raises: it does not compute the plain version."""
    q, x, add, keep = (torch.from_numpy(a).to("meta")
                       for a in _scan_inputs("all"))
    before = dict(st.launches)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        st.gated_topm_scan(q, x.to(torch.bfloat16), add, keep, **GEOMETRY)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        st.binned_scan(q.to(torch.float16), x.to(torch.float16), add,
                       bin_size=64, chunk=x.shape[0], packed=False,
                       prescaled=True, transpose=False)
    assert st.launches == before
