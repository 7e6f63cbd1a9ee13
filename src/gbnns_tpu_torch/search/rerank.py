"""Full-dimension re-rank of the search candidate pool.

One batched gather of the candidate rows and one batched fp32 product over
the whole query batch; the exact distances recover the recall lost to the
d→d' projection and to the scan's reduced precision.
"""

from __future__ import annotations

import torch

from gbnns_tpu_torch.kernels.distance import METRICS, exact_fp32, squared_norms


def rerank(queries_full, base_full, candidate_ids, k: int, *,
           metric: str = "l2", base_sqnorms: torch.Tensor | None = None):
    """Re-score ``candidate_ids (B, C)`` with exact full-dim distances and
    return the top ``k``: ``(ids (B, k) int32, dists (B, k) float32)``.

    Slots with id < 0 (unfilled pool entries), id >= n (padding-bin winners
    of the fused scan) and repeats of an id earlier in the row are excluded,
    so each id counts once. ``base_full`` may be bfloat16; ``base_sqnorms``
    (f32, taken before any cast) then keeps the norms exact.
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    B, C = candidate_ids.shape
    if k > C:
        raise ValueError(f"k={k} > candidate pool {C}")
    n = base_full.shape[0]
    qf = queries_full.float()
    q_sq = squared_norms(qf)
    x_sq = (squared_norms(base_full) if base_sqnorms is None
            else base_sqnorms.float())
    cand = candidate_ids.long()
    safe = cand.clamp(0, n - 1)
    vecs = base_full[safe].float()                                # (B, C, d)
    with exact_fp32():
        dots = torch.bmm(vecs, qf[:, :, None])[..., 0]
    if metric == "l2":
        dists = torch.clamp(q_sq[:, None] - 2.0 * dots + x_sq[safe], min=0.0)
    else:
        dists = -dots
    pos = torch.arange(C, device=cand.device)
    earlier = pos[None, :] < pos[:, None]                   # [i, j]: j < i
    repeat = ((cand[:, :, None] == cand[:, None, :]) & earlier).any(-1)
    valid = (cand >= 0) & (cand < n) & ~repeat
    dists = torch.where(valid, dists, torch.full_like(dists, float("inf")))
    top_d, order = torch.sort(dists, dim=1, stable=True)    # ties: lower slot
    top_ids = torch.gather(candidate_ids, 1, order[:, :k])
    return top_ids.to(torch.int32), top_d[:, :k]
