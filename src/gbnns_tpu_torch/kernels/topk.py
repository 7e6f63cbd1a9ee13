"""Streaming brute-force k-nearest-neighbour: tiled distances + running top-k.

The corpus is swept in chunks; each chunk's distances are one fp32 matrix
product, reduced at once to a per-chunk top-k and merged into a running
top-k, so peak memory is O(nq * chunk), never O(nq * n). Selection is exact
(``torch.topk``); the TPU's approximate top-k has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import pairwise_dists, squared_norms


def _smallest(d: torch.Tensor, i: torch.Tensor, k: int):
    """k smallest of ``d`` per row, ties to the earlier column."""
    top_d, order = torch.sort(d, dim=1, stable=True)
    return top_d[:, :k], torch.gather(i, 1, order[:, :k])


def knn_chunked(q: torch.Tensor, x: torch.Tensor, k: int, *,
                metric: str = "l2", chunk: int = 65536):
    """kNN of ``q (nq, d)`` against ``x (n, d)`` on their device:
    ``(dists (nq, k) f32, ids (nq, k) int32)`` ascending by distance.
    Both are taken in full fp32 whatever their stored type."""
    nq = q.shape[0]
    n = x.shape[0]
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    best_d = torch.full((nq, k), float("inf"), device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    for off in range(0, n, chunk):
        xc = x[off:off + chunk]
        d = pairwise_dists(q, xc, metric=metric,
                           x_sqnorms=squared_norms(xc))
        kk = min(k, d.shape[1])
        cd, ci = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        best_d, best_i = _smallest(torch.cat([best_d, cd], 1),
                                   torch.cat([best_i, ci + off], 1), k)
    return best_d, best_i.to(torch.int32)


def knn_fused(q: torch.Tensor, x: torch.Tensor, k: int, *,
              metric: str = "l2", chunk: int = 65536, q_chunk: int = 8192):
    """kNN of a large query block ``q (nq, d)`` against ``x (n, d)``: the
    corpus sweep of ``knn_chunked`` over query chunks of ``q_chunk``, so
    scores stay O(q_chunk * chunk). The exact backend of the graph build.
    Returns ``(dists (nq, k) f32, ids (nq, k) int32)`` on their device."""
    outs = [knn_chunked(q[off:off + q_chunk], x, k, metric=metric,
                        chunk=chunk)
            for off in range(0, q.shape[0], q_chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def knn(q, x, k: int, *, metric: str = "l2", chunk: int = 65536,
        q_chunk: int | None = None, device=None):
    """Host-level wrapper: accepts numpy arrays or tensors, moves them to
    ``device`` (the card unless the caller asks for the CPU), and tiles the
    query axis by ``q_chunk`` so large query sets stream through fixed
    device memory. Returns tensors on that device."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(q) if not torch.is_tensor(q) else q,
                        device=dev).float()
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=dev).float()
    return knn_fused(q, x, k, metric=metric, chunk=chunk,
                     q_chunk=q_chunk or max(1, q.shape[0]))
