"""Distances as matrix products: ``‖q‖² − 2 q·x + ‖x‖²`` for l2, ``−q·x``
for ip and angular (angular callers pre-normalize, after which it equals
ip). Smaller is closer for every metric.

Precision: the exact surfaces (ground truth, re-rank) run in full fp32.
A float32 product on the card may take TF32 (about three decimal digits)
when ``allow_tf32`` is on, so ``exact_fp32`` turns it off for cuBLAS and
cuDNN around every exact product and restores the caller's setting after.
"""

from __future__ import annotations

import contextlib

import torch

METRICS = ("l2", "ip", "angular")


@contextlib.contextmanager
def exact_fp32():
    """Full-fp32 matrix products inside the block (TF32 off). The flags are
    process-wide: leaving the block restores them for every thread."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, accumulated in float32. Shape (n,)."""
    xf = x.float()
    return (xf * xf).sum(-1)


def pairwise_dists(q: torch.Tensor, x: torch.Tensor, *, metric: str = "l2",
                   x_sqnorms: torch.Tensor | None = None) -> torch.Tensor:
    """All-pairs distances ``(nq, n)`` between ``q (nq, d)`` and ``x (n, d)``,
    in full fp32 whatever the input type. ``x_sqnorms`` hoists the base
    norms out of a chunked sweep."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    qf, xf = q.float(), x.float()
    with exact_fp32():
        dots = qf @ xf.T
    if metric in ("ip", "angular"):
        return -dots
    xs = squared_norms(xf) if x_sqnorms is None else x_sqnorms.float()
    # true squared L2, clamped at 0 to absorb cancellation
    return torch.clamp(squared_norms(qf)[:, None] - 2.0 * dots + xs[None, :],
                       min=0.0)
