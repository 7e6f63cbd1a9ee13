"""The exact fused kNN (T6): the port's ``knn_topk`` (on the CPU, through
``knn_topk_plain``) against the JAX package's ``knn_pallas`` in interpret
mode, as its own tests run it, on inputs made with numpy from a seed.

Tolerances: distances within 1e-5 relative (plus 1e-5 absolute, for
distances near 0 that are the difference of larger terms): the two packages
sum the products in another order. Ids equal except at near-ties: where
they differ, the float64 distance of each package's id agrees within
``TIE_RTOL`` of the largest distance. On a corpus of duplicated rows every
neighbour ties exactly with its copies, and ids must equal JAX's exactly:
ties go to the lower id."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.kernels.distance_topk_pallas import knn_pallas
from gbnns_tpu_torch.kernels import distance_topk as dt
from gbnns_tpu_torch.kernels import knn_topk

TIE_RTOL = 1e-5

# tests/test_pallas_kernels.py's shapes (nq, n, d, k, qt, xt)
SHAPES = [(100, 700, 32, 10, 64, 256), (64, 256, 16, 33, 64, 256),
          (80, 500, 24, 8, 64, 128), (10, 100, 8, 50, 8, 128)]


def _exact(q, x, metric):
    qd, xd = q.astype(np.float64), x.astype(np.float64)
    if metric == "l2":
        return ((qd[:, None, :] - xd[None, :, :]) ** 2).sum(-1)
    return -(qd @ xd.T)


def _agree(mine, ref, q, x, metric):
    md, mi = (t.numpy() for t in mine)
    rd, ri = np.asarray(ref[0]), np.asarray(ref[1])
    assert md.dtype == np.float32 and mi.dtype == np.int32
    assert md.shape == mi.shape == rd.shape
    np.testing.assert_allclose(md, rd, rtol=1e-5, atol=1e-5)
    assert (np.diff(md, axis=1) >= 0).all()
    exact = _exact(q, x, metric)
    tol = TIE_RTOL * np.abs(exact).max()
    miss = np.nonzero(mi != ri)
    rows = miss[0]
    np.testing.assert_allclose(exact[rows, mi[miss]], exact[rows, ri[miss]],
                               rtol=0, atol=tol)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("shape", SHAPES, ids=["-".join(map(str, s[:4]))
                                               for s in SHAPES])
def test_knn_topk_plain_matches_pallas(shape, metric):
    nq, n, d, k, qt, xt = shape
    rng = np.random.default_rng(nq + n)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ref = knn_pallas(jnp.asarray(q), jnp.asarray(x), k, metric=metric, qt=qt,
                     xt=xt, interpret=True)
    mine = knn_topk(torch.from_numpy(q), torch.from_numpy(x), k,
                    metric=metric, qt=qt, xt=xt)
    _agree(mine, ref, q, x, metric)
    assert (mine[1].numpy() < n).all() and (mine[1].numpy() >= 0).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_duplicated_rows_give_jax_ids(metric):
    """Rows stored three times at shuffled positions, and queries that are
    corpus rows: every neighbour ties with its copies."""
    rng = np.random.default_rng(11)
    rows = rng.normal(size=(200, 16)).astype(np.float32)
    x = np.tile(rows, (3, 1))[rng.permutation(600)]
    q = np.concatenate([x[:40], rng.normal(size=(24, 16)).astype(np.float32)])
    ref = knn_pallas(jnp.asarray(q), jnp.asarray(x), 9, metric=metric, qt=64,
                     xt=256, interpret=True)
    mine = dt.knn_topk_plain(torch.from_numpy(q), torch.from_numpy(x), 9,
                             metric=metric)
    np.testing.assert_array_equal(mine[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(mine[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)


def test_bf16_inputs_match_pallas():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((48, 32)).astype(np.float32)
    x = rng.standard_normal((600, 32)).astype(np.float32)
    qb, xb = jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    ref = knn_pallas(qb, xb, 12, qt=64, xt=256, interpret=True)
    mine = knn_topk(torch.from_numpy(q).to(torch.bfloat16),
                    torch.from_numpy(x).to(torch.bfloat16), 12)
    _agree(mine, ref, np.asarray(qb.astype(jnp.float32)),
           np.asarray(xb.astype(jnp.float32)), "l2")


def test_padding_is_never_selected():
    """A corpus already padded past ``n_valid`` (with rows nearer than any
    real one): only real rows come back, as JAX's."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((10, 8)).astype(np.float32)
    x = rng.standard_normal((128, 8)).astype(np.float32)
    x[100:] = q[0]                                 # distance 0 to query 0
    ref = knn_pallas(jnp.asarray(q), jnp.asarray(x), 50, qt=8, xt=128,
                     interpret=True, n_valid=100)
    mine = knn_topk(torch.from_numpy(q), torch.from_numpy(x), 50,
                    n_valid=100)
    assert (mine[1].numpy() < 100).all() and (mine[1].numpy() >= 0).all()
    _agree(mine, ref, q, x[:100], "l2")


def test_refusals_match_jax():
    q = torch.zeros(4, 8)
    x = torch.zeros(20, 8)
    for call in (lambda **kw: knn_pallas(jnp.zeros((4, 8)),
                                         jnp.zeros((20, 8)), interpret=True,
                                         **kw),
                 lambda **kw: knn_topk(q, x, **kw)):
        with pytest.raises(ValueError, match="k=21 > n=20"):
            call(k=21)
        with pytest.raises(ValueError, match="unknown metric"):
            call(k=3, metric="cosine")
    with pytest.raises(ValueError, match="k=6 > n=5"):
        knn_topk(q, x, 6, n_valid=5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        knn_topk(q.to(torch.float16), x.to(torch.float16), 3)


def test_tiles_change_no_result():
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((30, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((900, 24)).astype(np.float32))
    a = knn_topk(q, x, 7)
    b = knn_topk(q, x, 7, qt=32, xt=128)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert dt.launches["knn_topk"] == 0        # the CPU takes the plain path
