"""Synthetic ANN datasets with exact ground truth.

The environment is fully offline (SURVEY.md §0), so the standard corpora
(SIFT1M, GIST1M, GloVe-1.2M, DEEP10M — BASELINE.json:7-11) cannot be
downloaded. This module generates statistically similar stand-ins:
clustered-Gaussian point clouds whose dimension/metric/scale mirror each
corpus, so every pipeline stage (graph build, projection training, search,
eval) exercises the same shapes and dtypes it would on the real data. If real
corpora are mounted later, ``io.datasets`` prefers them automatically.

Clustered (rather than i.i.d.) data matters: graph-based search quality
depends on local neighborhood structure, and a mixture of anisotropic
Gaussians with a planted low-dimensional signal subspace gives the learned
d→d' projection something real to learn (matching the reference's premise
that neighborhoods are approximately preserved under a linear map).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    """Recipe for a synthetic corpus.

    ``signal_dim``: dimensionality of the subspace where cluster structure
    lives; remaining dims are lower-variance noise. This plants a recoverable
    structure for dimensionality reduction (PCA and the triplet net should
    both find it, the triplet net better).
    """

    n_base: int
    n_query: int
    dim: int
    metric: str = "l2"          # "l2" | "ip" | "angular"
    n_clusters: int = 64
    signal_dim: int | None = None
    # Ambient-noise scale. Chosen so noise contributes ~10% of a typical
    # near-neighbor distance²: real ANN corpora (SIFT/GIST/DEEP) have low
    # intrinsic dimension — their neighbor ordering survives a learned
    # d→d' projection, which is the reference paper's premise. At the old
    # default (0.35) noise distance² matched signal distance² in high
    # ambient dims, making even *exact* 32-d search cap at R@10≈0.55 —
    # unrepresentative of the corpora being stood in for.
    noise_scale: float = 0.12
    seed: int = 0

    def __post_init__(self):
        if self.metric not in ("l2", "ip", "angular"):
            raise ValueError(f"unknown metric {self.metric!r}")


def make_synthetic(spec: SyntheticSpec) -> dict[str, np.ndarray]:
    """Generate ``{"base", "query", "gt", "gt_dist"}`` for ``spec``.

    Queries are perturbed copies of base-distribution samples so that each
    query has meaningful near neighbors. Ground truth here is *not* computed
    (exact GT is the job of the brute-force kNN); this function only
    returns the raw point sets. Use
    ``gbnns_tpu_torch.eval.recall.exact_ground_truth`` for GT.
    """
    rng = np.random.default_rng(spec.seed)
    d = spec.dim
    # Default intrinsic (signal) dimension: d/8 capped at 32. Real
    # descriptor corpora have low intrinsic dimension regardless of ambient
    # dims (GIST-960's is ~20-50); an uncapped d/8=120 signal space made
    # cluster-overlap mass vanish by concentration of measure, so graph
    # navigation had no cross-cluster paths (walker capped at R@10≈0.45
    # while the flat scan, which needs no paths, reached 0.99).
    sd = spec.signal_dim or max(4, min(32, d // 8))
    sd = min(sd, d)

    # Cluster centers live in a random sd-dim subspace, embedded in d dims.
    # Center spread 1.5 vs within-cluster spread ~1.1: clusters OVERLAP, as
    # real corpora's neighborhoods do. (At the old 4.0 the clusters were
    # isolated islands — trivially compressible but pathological for graph
    # navigation: the 1M graph walker collapsed to R@1=0.50 because
    # cross-cluster paths existed only through repair bridges.)
    basis = rng.standard_normal((sd, d)).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    centers_lo = rng.standard_normal((spec.n_clusters, sd)).astype(np.float32) * 1.5
    centers = centers_lo @ basis

    # Per-dim noise shrinks above 128 ambient dims so TOTAL noise variance
    # stays bounded: real high-d descriptors (GIST 960d) have low intrinsic
    # dimension and a noise floor that does not grow with ambient dims —
    # without this, 840 noise dims swamp neighbor structure and no
    # projection (nor exact low-d search) can recover it.
    noise_std = spec.noise_scale * min(1.0, (128.0 / d) ** 0.5)

    def sample(n: int, seed_offset: int) -> np.ndarray:
        r = np.random.default_rng(spec.seed + seed_offset)
        assign = r.integers(0, spec.n_clusters, size=n)
        # In-subspace anisotropic spread + isotropic ambient noise.
        spread_lo = r.standard_normal((n, sd)).astype(np.float32)
        scales = (0.5 + r.random((spec.n_clusters, sd)).astype(np.float32))
        pts = centers[assign] + (spread_lo * scales[assign]) @ basis
        pts += noise_std * r.standard_normal((n, d)).astype(np.float32)
        return pts.astype(np.float32)

    base = sample(spec.n_base, 1)
    query = sample(spec.n_query, 2)

    if spec.metric == "angular":
        base /= np.maximum(np.linalg.norm(base, axis=1, keepdims=True), 1e-12)
        query /= np.maximum(np.linalg.norm(query, axis=1, keepdims=True), 1e-12)

    return {"base": base, "query": query}
