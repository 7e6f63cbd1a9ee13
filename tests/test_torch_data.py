"""Data, exact kNN and recall: the port against the JAX package on the same
inputs (JAX on the CPU)."""

import pathlib

import numpy as np
import pytest

from gbnns_tpu.eval.recall import recall_at_k as jax_recall_at_k
from gbnns_tpu.io import datasets as jax_datasets
from gbnns_tpu.io import synthetic as jax_synthetic
from gbnns_tpu.io import vecs as jax_vecs
from gbnns_tpu.kernels.topk import knn as jax_knn
from gbnns_tpu_torch.eval.recall import exact_ground_truth, recall_at_k
from gbnns_tpu_torch.io import datasets, synthetic, vecs
from gbnns_tpu_torch.kernels.topk import knn

ROOT = pathlib.Path(__file__).resolve().parents[1]

SPECS = [
    dict(n_base=3000, n_query=64, dim=128, n_clusters=64, seed=0),
    dict(n_base=1500, n_query=40, dim=300, metric="angular", n_clusters=16,
         seed=3),
    dict(n_base=800, n_query=16, dim=40, metric="ip", signal_dim=7,
         noise_scale=0.3, seed=11),
]


@pytest.mark.parametrize("spec", SPECS)
def test_make_synthetic_is_byte_identical(spec):
    mine = synthetic.make_synthetic(synthetic.SyntheticSpec(**spec))
    ref = jax_synthetic.make_synthetic(jax_synthetic.SyntheticSpec(**spec))
    assert mine.keys() == ref.keys()
    for key in ref:
        assert mine[key].dtype == ref[key].dtype
        assert mine[key].tobytes() == ref[key].tobytes()


def test_synthetic_spec_rejects_unknown_metric():
    with pytest.raises(ValueError):
        synthetic.SyntheticSpec(n_base=1, n_query=1, dim=2, metric="cos")


@pytest.mark.parametrize("ext,dtype", [(".fvecs", np.float32),
                                       (".ivecs", np.int32)])
def test_vecs_files_interoperate(tmp_path, ext, dtype):
    rng = np.random.default_rng(1)
    arr = (rng.normal(size=(37, 9)) * 100).astype(dtype)
    vecs.write_vecs(str(tmp_path / f"a{ext}"), arr)
    jax_vecs.write_vecs(str(tmp_path / f"b{ext}"), arr)
    assert (tmp_path / f"a{ext}").read_bytes() == \
        (tmp_path / f"b{ext}").read_bytes()
    np.testing.assert_array_equal(vecs.read_vecs(str(tmp_path / f"b{ext}")),
                                  arr)
    chunks = list(vecs.iter_vecs(str(tmp_path / f"a{ext}"), chunk=10))
    np.testing.assert_array_equal(np.concatenate(chunks), arr)


def test_load_dataset_matches(monkeypatch, tmp_path):
    monkeypatch.setenv("GBNNS_DATA_DIR", str(tmp_path))
    mine = datasets.load_dataset("fixture", seed=2)
    ref = jax_datasets.load_dataset("fixture", seed=2)
    assert mine.source == ref.source == "synthetic"
    assert mine.base.tobytes() == ref.base.tobytes()
    assert mine.query.tobytes() == ref.query.tobytes()


def test_exact_ground_truth_equals_cached_bench_gt():
    data = synthetic.make_synthetic(synthetic.SyntheticSpec(
        n_base=20000, n_query=1024, dim=128, n_clusters=64, seed=0))
    with np.load(ROOT / "results" / "bench_gt_n20000_q1024_seed0.npz") as f:
        gt = f["gt"]
    mine = exact_ground_truth(data["query"], data["base"], k=gt.shape[1],
                              device="cpu")
    np.testing.assert_array_equal(mine, gt)


@pytest.mark.parametrize("metric", ["l2", "ip", "angular"])
def test_knn_matches_jax(metric):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3000, 24)).astype(np.float32)
    q = rng.normal(size=(70, 24)).astype(np.float32)
    if metric == "angular":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    jd, ji = jax_knn(q, x, 10, metric=metric, chunk=1024)
    md, mi = knn(q, x, 10, metric=metric, chunk=1024, q_chunk=32,
                 device="cpu")
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    # fp32 sums in another order; distances are O(10)
    np.testing.assert_allclose(md.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)


def test_knn_rejects_k_above_n():
    with pytest.raises(ValueError):
        knn(np.zeros((2, 3), np.float32), np.zeros((4, 3), np.float32), 5,
            device="cpu")


@pytest.mark.parametrize("k", [1, 5, 10])
def test_recall_at_k_matches_jax(k):
    rng = np.random.default_rng(k)
    gt = np.stack([rng.permutation(500)[:10] for _ in range(64)])
    pred = gt.copy()
    pred[:, ::3] = rng.integers(0, 500, size=pred[:, ::3].shape)
    pred[::4, 1] = -1
    pred[::5, 2] = pred[::5, 0]          # repeated id earns once
    assert recall_at_k(pred, gt, k) == jax_recall_at_k(pred, gt, k)
    assert recall_at_k(gt, gt, k) == 1.0
