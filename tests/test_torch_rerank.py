"""Re-rank and the flat index: the port against the JAX package on the same
inputs (JAX on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.search.flat import FlatIndex as JaxFlatIndex
from gbnns_tpu.search.rerank import rerank as jax_rerank
from gbnns_tpu_torch.eval.recall import recall_at_k
from gbnns_tpu_torch.search.flat import FlatIndex
from gbnns_tpu_torch.search.rerank import rerank


def _pool(n=500, d=24, B=40, C=24, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    cand = rng.integers(0, n, size=(B, C)).astype(np.int32)
    cand[:, 3] = -1                      # unfilled slots
    cand[::2, 5] = n + 7                 # padding-bin winners
    cand[:, 6] = cand[:, 0]              # repeats
    cand[1::3, 9] = cand[1::3, 2]
    return base, q, cand


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rerank_matches_jax(metric, dtype):
    base, q, cand = _pool(seed=len(metric) + len(dtype))
    sq = (base * base).sum(-1)
    if dtype == "bfloat16":
        jb = jnp.asarray(base, dtype=jnp.bfloat16)
        tb = torch.from_numpy(base).to(torch.bfloat16)
        jsq, tsq = jnp.asarray(sq), torch.from_numpy(sq)
    else:
        jb, tb = jnp.asarray(base), torch.from_numpy(base)
        jsq = tsq = None
    ji, jd = jax_rerank(jnp.asarray(q), jb, jnp.asarray(cand), 10,
                        metric=metric, base_sqnorms=jsq)
    mi, md = rerank(torch.from_numpy(q), tb, torch.from_numpy(cand), 10,
                    metric=metric, base_sqnorms=tsq)
    assert mi.dtype == torch.int32
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(md.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    ids = mi.numpy()
    assert ids.min() >= 0 and ids.max() < base.shape[0]
    assert all(len(set(r)) == len(r) for r in ids.tolist())


def test_rerank_fills_with_inf_when_pool_is_short():
    base, q, _ = _pool(B=3)
    cand = torch.tensor([[0, -1, -1, -1], [1, 1, 2, -1], [900, 3, 4, 5]],
                        dtype=torch.int32)
    ids, dists = rerank(torch.from_numpy(q), torch.from_numpy(base), cand, 3)
    assert torch.isinf(dists[0, 1:]).all() and ids[0, 0] == 0
    assert torch.isinf(dists[1, 2]) and set(ids[1, :2].tolist()) == {1, 2}
    assert torch.isfinite(dists[2]).all()


def test_rerank_rejects_k_above_pool():
    base, q, cand = _pool()
    with pytest.raises(ValueError):
        rerank(torch.from_numpy(q), torch.from_numpy(base),
               torch.from_numpy(cand[:, :4]), 5)


@pytest.mark.parametrize("projected", [False, True])
def test_flat_index_matches_jax(fixture_data, fixture_gt, projected):
    base, query = fixture_data
    base_lo = qlo = None
    if projected:
        w = np.random.default_rng(5).normal(size=(32, 16)).astype(np.float32)
        base_lo, qlo = base @ w, query @ w
    ji, jd = JaxFlatIndex(base, base_lo).search(query, qlo, k=10, c=32)
    mi, md = FlatIndex(base, base_lo, device="cpu").search(query, qlo, k=10,
                                                           c=32)
    same = (mi.numpy() == np.asarray(ji)).all(axis=1).mean()
    assert same >= 0.99
    assert abs(recall_at_k(mi.numpy(), fixture_gt, 10)
               - recall_at_k(np.asarray(ji), fixture_gt, 10)) <= 0.01
