"""Dataset registry: the reference corpora, with synthetic fallback.

Capability parity: the reference's download scripts + path conventions for
SIFT1M / GIST1M / GloVe-1.2M / DEEP10M (SURVEY.md §3 "Dataset registry";
BASELINE.json:7-11). The environment is offline, so each entry resolves in
order:

1. real TEXMEX files under ``$GBNNS_DATA_DIR/<name>/`` (``base.fvecs``,
   ``query.fvecs``, optional ``groundtruth.ivecs``) — used if present;
2. a synthetic stand-in with matching dim/metric (scaled down by
   ``scale`` to keep offline runs tractable; pass ``scale=1.0`` for the
   full advertised size).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from gbnns_tpu_torch.io.synthetic import SyntheticSpec, make_synthetic
from gbnns_tpu_torch.io.vecs import read_fvecs, read_ivecs


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    name: str
    n_base: int
    n_query: int
    dim: int
    metric: str  # "l2" | "ip" | "angular"


# Advertised shapes of the reference corpora (BASELINE.json:7-11).
DATASETS: dict[str, DatasetInfo] = {
    "sift1m": DatasetInfo("sift1m", 1_000_000, 10_000, 128, "l2"),
    "gist1m": DatasetInfo("gist1m", 1_000_000, 1_000, 960, "l2"),
    "glove": DatasetInfo("glove", 1_183_514, 10_000, 300, "angular"),
    "deep10m": DatasetInfo("deep10m", 10_000_000, 10_000, 96, "l2"),
    # Tiny fixture used by the offline test-suite (SURVEY.md §7.4).
    "fixture": DatasetInfo("fixture", 2048, 128, 32, "l2"),
}


@dataclasses.dataclass
class Dataset:
    info: DatasetInfo
    base: np.ndarray       # (n_base, dim) float32
    query: np.ndarray      # (n_query, dim) float32
    gt: np.ndarray | None  # (n_query, k) int32 exact NN ids, if available
    source: str            # "files" | "synthetic"


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def data_dir() -> str:
    return os.environ.get("GBNNS_DATA_DIR", os.path.expanduser("~/gbnns_data"))


def load_dataset(name: str, *, scale: float = 1.0, seed: int = 0,
                 max_base: int | None = None) -> Dataset:
    """Load a registered dataset, preferring real files over synthetic.

    ``scale`` multiplies the advertised base/query counts for the synthetic
    path (offline test/bench runs typically use scale<1). ``max_base`` caps
    the base-set size for either path.
    """
    info = DATASETS[name]
    root = os.path.join(data_dir(), name)
    base_p = os.path.join(root, "base.fvecs")
    query_p = os.path.join(root, "query.fvecs")
    if os.path.exists(base_p) and os.path.exists(query_p):
        base = np.ascontiguousarray(read_fvecs(base_p), dtype=np.float32)
        query = np.ascontiguousarray(read_fvecs(query_p), dtype=np.float32)
        if info.metric == "angular":
            # The distance kernels treat "angular" as -dot over pre-normalized
            # vectors (distance.py); the synthetic path normalizes at
            # generation time, so real files must be normalized here too or a
            # GloVe mount would be searched by raw inner product.
            base = _l2_normalize(base)
            query = _l2_normalize(query)
        gt_p = os.path.join(root, "groundtruth.ivecs")
        gt = np.ascontiguousarray(read_ivecs(gt_p)) if os.path.exists(gt_p) else None
        if max_base is not None and base.shape[0] > max_base:
            base, gt = base[:max_base], None  # GT invalidated by truncation
        return Dataset(info, base, query, gt, "files")

    n_base = int(info.n_base * scale)
    if max_base is not None:
        n_base = min(n_base, max_base)
    n_query = max(16, int(info.n_query * min(1.0, scale * 4)))
    spec = SyntheticSpec(
        n_base=n_base, n_query=n_query, dim=info.dim, metric=info.metric,
        n_clusters=max(16, min(1024, n_base // 1000)), seed=seed,
    )
    data = make_synthetic(spec)
    return Dataset(info, data["base"], data["query"], None, "synthetic")
