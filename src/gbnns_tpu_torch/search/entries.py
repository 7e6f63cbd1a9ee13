"""Per-query entry points of the graph walkers: centroid entries.

Port of ``gbnns_tpu/search/entries.py``. A coarse k-means quantizer
(``build/kmeans.py``) picks each query's E nearest centroids, and the walk
starts at those clusters' representative nodes, skipping the hops a walk
from fixed entries spends descending into the right cluster. The quantizer
is staged as an npz with the JAX package's keys, so either package loads
the other's file.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import pairwise_dists, squared_norms
from gbnns_tpu_torch.kernels.topk import knn_chunked, smallest_k


@dataclasses.dataclass
class CentroidEntries:
    """Coarse quantizer + one representative (nearest real node) per
    centroid. ``query_entries`` maps a query batch to (B, E) start nodes."""

    centroids: torch.Tensor   # (ncent, d_lo) f32
    cent_sq: torch.Tensor     # (ncent,) f32
    node_ids: torch.Tensor    # (ncent,) int32: nearest corpus row per centroid
    metric: str

    @classmethod
    def build(cls, base_lo, *, ncent: int = 1024, metric: str = "l2",
              iters: int = 8, seed: int = 0, sample: int | None = 262_144,
              device=None) -> "CentroidEntries":
        from gbnns_tpu_torch.build.kmeans import kmeans_fit

        dev = resolve_device(device)
        lo = np.asarray(base_lo, np.float32)
        ncent = max(8, min(ncent, lo.shape[0]))
        cent = torch.from_numpy(kmeans_fit(lo, ncent, iters=iters, seed=seed,
                                           sample=sample, device=dev)).to(dev)
        # each centroid's representative: its nearest corpus row (exact)
        _, ids = knn_chunked(cent, torch.from_numpy(lo).to(dev), 1,
                             metric=metric)
        return cls(centroids=cent, cent_sq=squared_norms(cent),
                   node_ids=ids[:, 0].to(torch.int32), metric=metric)

    def save(self, path: str) -> None:
        """Stage the quantizer as a flat npz (no pickling), so a restarted
        service loads it instead of refitting."""
        np.savez(path, centroids=self.centroids.cpu().numpy(),
                 cent_sq=self.cent_sq.cpu().numpy(),
                 node_ids=self.node_ids.cpu().numpy(),
                 metric=np.array(self.metric))

    @classmethod
    def load(cls, path: str, *, device=None) -> "CentroidEntries":
        z = np.load(path, allow_pickle=False)
        return cls.from_arrays(z["centroids"], z["cent_sq"], z["node_ids"],
                               str(z["metric"]), device=device)

    @classmethod
    def from_arrays(cls, centroids, cent_sq, node_ids, metric: str, *,
                    device=None) -> "CentroidEntries":
        dev = resolve_device(device)

        def put(a, dtype):
            return torch.tensor(np.asarray(a, dtype), device=dev)

        return cls(centroids=put(centroids, np.float32),
                   cent_sq=put(cent_sq, np.float32),
                   node_ids=put(node_ids, np.int32), metric=metric)

    def query_entries(self, queries_lo, E: int) -> torch.Tensor:
        """(B, E) int32 start nodes: representatives of the E nearest
        centroids, nearest first (a row may repeat a node when two centroids
        share a representative; the walker's dedup absorbs it). The JAX
        package's approximate top-k becomes an exact one, ties to the lower
        centroid."""
        q = torch.as_tensor(queries_lo, dtype=torch.float32,
                            device=self.centroids.device)
        d = pairwise_dists(q, self.centroids, metric=self.metric,
                           x_sqnorms=self.cent_sq)
        _, sel = smallest_k(d, min(E, self.centroids.shape[0]))
        return self.node_ids[sel]


def entries_from_jax(ce, *, device=None) -> CentroidEntries:
    """The port's ``CentroidEntries`` from the JAX package's (its arrays are
    read through numpy), so both walkers can start from the same nodes."""
    return CentroidEntries.from_arrays(ce.centroids, ce.cent_sq, ce.node_ids,
                                       ce.metric, device=device)
