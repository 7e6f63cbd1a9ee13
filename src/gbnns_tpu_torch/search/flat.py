"""Flat (brute-force) search over the reduced space + full-dim re-rank.

    score = Q_lo @ X_lo^T (fp32 products of the stored values) → top-c per
    query → exact full-dim re-rank of the c candidates.

Recall is governed by c. The scores of each corpus chunk are written to
device memory before selection, which is what the fused scan avoids; this
is the plain baseline the fused engine is compared with.
"""

from __future__ import annotations

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import squared_norms
from gbnns_tpu_torch.kernels.topk import knn_chunked
from gbnns_tpu_torch.search.rerank import rerank


def flat_search(queries_lo, base_lo, queries_full, base_full, k: int, *,
                c: int = 32, metric: str = "l2", chunk: int = 65536,
                exact: bool = False, precision: str | None = "default",
                base_full_sqnorms: torch.Tensor | None = None):
    """Scan the reduced space for the top-``c`` candidates, re-rank at full
    dimension, return ``(ids (B, k) int32, dists (B, k) f32)``. ``exact``
    and ``precision`` are the JAX keywords, accepted and changing no
    result: the candidate scan is always exact, with fp32 products of the
    stored values."""
    _, si = knn_chunked(queries_lo, base_lo, c, metric=metric, chunk=chunk)
    return rerank(queries_full, base_full, si, k, metric=metric,
                  base_sqnorms=base_full_sqnorms)


class FlatIndex:
    """Device-resident corpus (full f32, reduced in ``scan_dtype``)."""

    def __init__(self, base_full, base_lo=None, *, metric: str = "l2",
                 scan_dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.metric = metric
        self.base_full = torch.from_numpy(
            np.ascontiguousarray(base_full, np.float32)).to(self.device)
        lo = self.base_full if base_lo is None else torch.from_numpy(
            np.ascontiguousarray(base_lo, np.float32)).to(self.device)
        self.base_lo = lo.to(scan_dtype)
        self.base_full_sqnorms = squared_norms(self.base_full)

    def search(self, queries_full, queries_lo=None, *, k: int = 10,
               c: int = 32, exact: bool = False):
        """``flat_search`` over the stored corpus; ``exact`` as there."""
        qf = torch.as_tensor(queries_full, dtype=torch.float32,
                             device=self.device)
        ql = qf if queries_lo is None else torch.as_tensor(
            queries_lo, dtype=torch.float32, device=self.device)
        ql = ql.to(self.base_lo.dtype)
        return flat_search(ql, self.base_lo, qf, self.base_full, k, c=c,
                           metric=self.metric,
                           base_full_sqnorms=self.base_full_sqnorms)
