"""Recall metrics and exact ground truth (the streaming exact kNN of
``kernels.topk``, queries against base)."""

from __future__ import annotations

import numpy as np

from gbnns_tpu_torch.kernels.topk import knn


def exact_ground_truth(queries, base, k: int = 100, *, metric: str = "l2",
                       chunk: int = 65536, q_chunk: int | None = 4096,
                       device=None) -> np.ndarray:
    """Exact top-k ids of each query: (nq, k) int32, ascending distance."""
    _, ids = knn(queries, base, k, metric=metric, chunk=chunk,
                 q_chunk=q_chunk, device=device)
    return ids.cpu().numpy()


def recall_at_k(pred_ids, gt_ids, k: int) -> float:
    """Fraction of the true top-k found in the predicted top-k
    (|pred[:k] ∩ gt[:k]| / k, averaged over queries). Negative and repeated
    predicted ids earn nothing."""
    pred = np.asarray(pred_ids)[:, :k].astype(np.int64)
    gt = np.asarray(gt_ids)[:, :k].astype(np.int64)
    if pred.shape[0] != gt.shape[0]:
        raise ValueError(f"query count mismatch {pred.shape} vs {gt.shape}")
    nq = gt.shape[0]

    # Rows are made disjoint by a per-row offset so one flat sorted
    # membership test covers all queries.
    order = np.argsort(pred, axis=1, kind="stable")
    ps = np.take_along_axis(pred, order, axis=1)
    dup_sorted = np.zeros_like(ps, dtype=bool)
    dup_sorted[:, 1:] = ps[:, 1:] == ps[:, :-1]
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, axis=1)

    stride = np.int64(max(int(pred.max(initial=0)), int(gt.max(initial=0))) + 2)
    offset = np.arange(nq, dtype=np.int64)[:, None] * stride
    p_keys = np.where((pred >= 0) & ~dup, pred + offset, np.int64(-1)).ravel()
    g_keys = np.sort((gt + offset).ravel())
    pos = np.searchsorted(g_keys, p_keys)
    pos = np.minimum(pos, g_keys.size - 1)
    hits = int(np.count_nonzero(g_keys[pos] == p_keys))
    return hits / (nq * k)
