"""Streaming brute-force k-nearest-neighbour: tiled distances + running top-k.

The corpus is swept in chunks; each chunk's distances are one fp32 matrix
product, reduced at once to a per-chunk top-k and merged into a running
top-k, so peak memory is O(nq * chunk), never O(nq * n). Selection is exact
(``torch.topk``); the TPU's approximate top-k has no counterpart here.

The sweeps take the JAX package's ``exact``, ``recall_target`` and
``precision`` keywords with the same names and order. Selection stays exact
whatever ``exact`` and ``recall_target`` say (``exact=False`` asked the TPU
for ``approx_max_k``), and the products always run in full fp32 with TF32
off, which is what JAX's ``precision="highest"`` gives; ``precision`` is
accepted and changes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import pairwise_dists, squared_norms


def _smallest_by_key(d: torch.Tensor, k: int):
    """``smallest_k`` by a key that is unique per column: the value's IEEE
    bits in signed-int order times 2^32, OR'd with the column (int64, 8
    bytes an entry beside the 4 of ``d``)."""
    bits = (d + 0.0).view(torch.int32)              # -0.0 orders as +0.0
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    del bits
    key *= 1 << 32                                  # a shift, defined for < 0
    key |= torch.arange(d.shape[1], device=d.device, dtype=torch.int64)
    top, _ = torch.topk(key, k, dim=1, largest=False, sorted=True)
    cols = top & 0xFFFFFFFF
    return torch.gather(d, 1, cols), cols


def smallest_k(d: torch.Tensor, k: int):
    """The ``k`` smallest f32 values of each row of ``d (rows, cols)`` in
    ascending order, ties to the lower column, as ``lax.top_k`` breaks
    them: ``(vals, cols int64)``.

    ``torch.topk`` picks the right values but breaks ties arbitrarily. So
    it selects k + 1: a row whose (k+1)-th value differs from its k-th has
    every copy of its k-th value inside the selection, which is then put
    in (value, column) order; a row where they are equal (a tie across the
    boundary) is selected again by ``_smallest_by_key``, whose int64 keys
    cost 8 bytes an entry of those rows."""
    d = d.float()
    vals, cols = torch.topk(d, min(k + 1, d.shape[1]), dim=1, largest=False,
                            sorted=True)
    tied = (vals[:, k:] == vals[:, k - 1:k]).any(dim=1).nonzero()[:, 0]
    cols, order = torch.sort(cols[:, :k], dim=1)
    vals, order = torch.sort(torch.gather(vals[:, :k], 1, order), dim=1,
                             stable=True)
    cols = torch.gather(cols, 1, order)
    if tied.numel():
        vals[tied], cols[tied] = _smallest_by_key(d[tied], k)
    return vals, cols


def _smallest(d: torch.Tensor, i: torch.Tensor, k: int):
    """k smallest of ``d`` per row, ties to the earlier column."""
    top_d, order = torch.sort(d, dim=1, stable=True)
    return top_d[:, :k], torch.gather(i, 1, order[:, :k])


def knn_chunked(q: torch.Tensor, x: torch.Tensor, k: int, *,
                metric: str = "l2", chunk: int = 65536, exact: bool = True,
                recall_target: float = 0.99, precision: str | None = None):
    """kNN of ``q (nq, d)`` against ``x (n, d)`` on their device:
    ``(dists (nq, k) f32, ids (nq, k) int32)`` ascending by distance, ties
    to the lower id. Both are taken in full fp32 whatever their stored type.
    Rows with a tie across a chunk's k-th value are selected again on 8-byte
    keys (``smallest_k``). ``exact``, ``recall_target`` and ``precision``
    are JAX's keywords; the result is exact whatever they say (module
    docstring)."""
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
        cd, ci = smallest_k(d, kk)
        best_d, best_i = _smallest(torch.cat([best_d, cd], 1),
                                   torch.cat([best_i, ci + off], 1), k)
    return best_d, best_i.to(torch.int32)


def knn_fused(q: torch.Tensor, x: torch.Tensor, k: int, *,
              metric: str = "l2", chunk: int = 65536, q_chunk: int = 8192,
              exact: bool = True, recall_target: float = 0.99,
              precision: str | None = None):
    """kNN of a large query block ``q (nq, d)`` against ``x (n, d)``: the
    corpus sweep of ``knn_chunked`` over query chunks of ``q_chunk``, so
    scores stay O(q_chunk * chunk). The exact backend of the graph build.
    Returns ``(dists (nq, k) f32, ids (nq, k) int32)`` on their device."""
    outs = [knn_chunked(q[off:off + q_chunk], x, k, metric=metric,
                        chunk=chunk, exact=exact, recall_target=recall_target,
                        precision=precision)
            for off in range(0, q.shape[0], q_chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def knn(q, x, k: int, *, metric: str = "l2", chunk: int = 65536,
        q_chunk: int | None = None, exact: bool = True,
        recall_target: float = 0.99, precision: str | None = None,
        device=None):
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
                     q_chunk=q_chunk or max(1, q.shape[0]), exact=exact,
                     recall_target=recall_target, precision=precision)
