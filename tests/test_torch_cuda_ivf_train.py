"""The IVF index, PCA, the projection trainer and the eval helpers on the
card against the same on the CPU.

These need an NVIDIA GPU, so they carry the ``cuda`` marker and skip without
a card. On a machine with one (which has no JAX), run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_ivf_train.py

Tolerances: IVF ids equal but for counted near-ties (exact distances within
1e-5 relative of each other, at most 1 % of the rows) and distances within
1e-5 relative (the card's bf16 products sum in fp32 in another order);
PCA components up to sign within 1e-4, and one model's transform on both
devices within 1e-5; twenty training steps on the same draws: losses
within 1e-4 relative. This file imports neither JAX nor the
JAX package.
"""

import json

import numpy as np
import pytest
import torch

from gbnns_tpu_torch.dimred import pca, train
from gbnns_tpu_torch.eval import bench, trace
from gbnns_tpu_torch.eval.recall import exact_ground_truth
from gbnns_tpu_torch.search.ivf import IVFIndex

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n, d, d_lo, nq = 20000, 32, 16, 500
    cents = rng.normal(size=(64, d)) * 3.0
    base = (cents[rng.integers(0, 64, n)]
            + rng.normal(size=(n, d))).astype(np.float32)
    query = (cents[rng.integers(0, 64, nq)]
             + rng.normal(size=(nq, d))).astype(np.float32)
    proj = np.linalg.qr(rng.normal(size=(d, d)))[0][:, :d_lo]
    return base, query, (base @ proj).astype(np.float32), \
        (query @ proj).astype(np.float32)


def _agree(ref, got, tol=1e-5):
    ri, rd = (a.cpu().numpy() for a in ref)
    gi, gd = (a.cpu().numpy() for a in got)
    scale = np.abs(rd).max(axis=1, keepdims=True) + 1e-30
    np.testing.assert_array_less(np.abs(gd - rd) / scale, tol)
    rows = np.nonzero((ri != gi).any(axis=1))[0]
    for r in rows:
        for pos in np.nonzero(ri[r] != gi[r])[0]:
            assert abs(rd[r, pos] - gd[r, pos]) <= tol * scale[r, 0]
    assert len(rows) <= 0.01 * ri.shape[0], len(rows)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("slack", [2.0, 0.25])
def test_ivf_on_the_card_equals_the_cpu(dev, data, metric, dtype, slack):
    base, query, lo, qlo = data
    cpu = IVFIndex.build(base, lo, metric=metric, scan_dtype=dtype,
                         device="cpu")
    card = IVFIndex.build(base, lo, metric=metric, scan_dtype=dtype,
                          centroids=cpu.centroids.numpy(), device=dev)
    assert torch.equal(card.block_ids.cpu(), cpu.block_ids)
    assert card.stats == cpu.stats
    _agree(cpu.search(query, qlo, k=10, c=32, probes=8, slack=slack),
           card.search(query, qlo, k=10, c=32, probes=8, slack=slack))


def test_ivf_search_waits_for_no_host(dev, data):
    base, query, lo, qlo = data
    idx = IVFIndex.build(base, lo, device=dev)
    qf = torch.from_numpy(query).to(dev)
    ql = torch.from_numpy(qlo).to(dev)
    idx.search(qf, ql, k=10, c=32, probes=16)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, dists = idx.search(qf, ql, k=10, c=32, probes=16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ids.shape == (query.shape[0], 10) and torch.isfinite(dists).all()


def test_pca_on_the_card_equals_the_cpu(dev, data):
    base = data[0]
    cpu = pca.pca_fit(base, 8, chunk=4096, device="cpu")
    card = pca.pca_fit(base, 8, chunk=4096, device=dev)
    sign = np.sign((cpu.components * card.components).sum(0))
    np.testing.assert_allclose(card.components * sign, cpu.components,
                               atol=1e-4)
    np.testing.assert_allclose(card.explained_variance,
                               cpu.explained_variance, rtol=1e-5)
    # one model on both devices: fp32 products summed in another order
    np.testing.assert_allclose(
        pca.pca_transform(card, base[:100], device=dev),
        pca.pca_transform(card, base[:100], device="cpu"), rtol=1e-5,
        atol=1e-5)


def test_training_on_the_card_replays_the_cpu(dev, data, monkeypatch):
    base = data[0][:4000]
    nbrs = exact_ground_truth(base, base, k=11, device=dev)[:, 1:]
    cfg = train.TrainConfig(d_out=8, steps=20, batch_size=256, k_pos=10,
                            seed=2)
    gen = torch.Generator().manual_seed(9)
    draws = [train.draw_batch(gen, base.shape[0], cfg) for _ in range(20)]

    def replay(device):
        it = iter(draws)
        monkeypatch.setattr(train, "draw_batch",
                            lambda g, n, c: tuple(t.to(g.device)
                                                  for t in next(it)))
        return train.train_projection(base, nbrs, cfg, device=device)

    cpu, card = replay("cpu"), replay(dev)
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-4)


def test_training_selection_on_the_card(dev, data):
    base = data[0][:4000]
    nbrs = exact_ground_truth(base, base, k=11, device=dev)[:, 1:]
    cfg = train.TrainConfig(d_out=8, steps=40, batch_size=256, k_pos=10,
                            eval_every=10, init="orthogonal")
    out = train.train_projection(base, nbrs, cfg, device=dev)
    hist = out["val_history"]
    assert len(hist) == 5 and out["best_val"] == hist.max() >= hist[0]
    assert np.isfinite(out["losses"]).all()
    assert next(out["model"].parameters()).is_cuda


def test_eval_helpers_on_the_card(dev, tmp_path):
    x = torch.randn(4096, 64, device=dev)
    qps, lat, out = bench.time_search(lambda: torch.topk(x @ x.T, 8), 4096)
    assert qps > 0 and lat > 0 and out[0].is_cuda
    mem = trace.memory_analysis(lambda a: a @ a.T, x)
    assert mem["temp_size_in_bytes"] >= 4096 * 4096 * 4
    with trace.profile_trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("stage"):
            (x @ x.T).sum().item()
    events = json.loads((tmp_path / trace.TRACE_FILE).read_text())
    cats = {e.get("cat") for e in events["traceEvents"]}
    assert "kernel" in cats, cats
    assert any(r.key == "stage" for r in prof.key_averages())
