"""k-means: the coarse quantizer behind the graph walker's centroid entries.

Port of ``gbnns_tpu/build/kmeans.py``. Lloyd's iterations run over row
chunks on the device. As in the JAX module, a chunk's centroid sums are one
matrix product of its one-hot assignment with its rows (never a scatter,
whose atomic adds would sum in a run-dependent order), and the rows enter
that product rounded to bf16 with fp32 sums, so both packages move the
centroids alike. Distances for the assignment are fp32 (TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import (exact_fp32, pairwise_dists,
                                              squared_norms)


def _assign(x: torch.Tensor, cents: torch.Tensor,
            c_sq: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row of ``x`` (ties to the lower centroid)."""
    return pairwise_dists(x, cents, metric="l2", x_sqnorms=c_sq).argmin(dim=1)


@torch.no_grad()
def _lloyd(x: torch.Tensor, cents: torch.Tensor, *, iters: int,
           chunk: int) -> torch.Tensor:
    """``iters`` Lloyd iterations of ``cents (ncent, d)`` over ``x (m, d)``.
    An empty cluster keeps its centroid."""
    ncent, d = cents.shape
    for _ in range(iters):
        c_sq = squared_norms(cents)
        sums = torch.zeros((ncent, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros(ncent, dtype=torch.float32, device=x.device)
        for off in range(0, x.shape[0], chunk):
            xc = x[off:off + chunk]
            onehot = torch.nn.functional.one_hot(
                _assign(xc, cents, c_sq), ncent).float()
            with exact_fp32():
                sums += onehot.T @ xc.to(torch.bfloat16).float()
            counts += onehot.sum(dim=0)
        cents = torch.where(counts[:, None] > 0,
                            sums / counts.clamp(min=1.0)[:, None], cents)
    return cents


def kmeans_fit(x, ncent: int, *, iters: int = 10, seed: int = 0,
               sample: int | None = 262_144, chunk: int = 16_384,
               init=None, device=None) -> np.ndarray:
    """Fit ``ncent`` centroids to ``x (n, d)``: (ncent, d) float32.

    ``sample`` caps the rows used for fitting (a random subset). The subset
    and the initial centroids are drawn as the JAX package draws them, from
    one ``np.random.default_rng(seed)``: the subset first (only when
    ``sample < n``), then ``ncent`` distinct rows of it, so the same seed
    starts from the same centroids in both packages. ``init`` (ncent, d)
    gives the initial centroids instead.
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if ncent > n:
        raise ValueError(f"ncent={ncent} > n={n}")
    rng = np.random.default_rng(seed)
    if sample is not None and sample < n:
        x = x[rng.choice(n, size=sample, replace=False)]
    if init is None:
        init = x[rng.choice(x.shape[0], size=ncent, replace=False)]
    init = np.asarray(init, np.float32)
    if init.shape != (ncent, d):
        raise ValueError(f"init has shape {init.shape}, not {(ncent, d)}")
    cents = _lloyd(torch.from_numpy(x).to(dev), torch.from_numpy(init).to(dev),
                   iters=iters, chunk=chunk)
    return cents.cpu().numpy()


@torch.no_grad()
def kmeans_assign(x, centroids, *, chunk: int = 65_536,
                  device=None) -> np.ndarray:
    """Nearest-centroid id per row of ``x``: (n,) int32."""
    dev = resolve_device(device)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    cents = torch.tensor(np.asarray(centroids, np.float32), device=dev)
    c_sq = squared_norms(cents)
    out = [_assign(xt[off:off + chunk], cents, c_sq)
           for off in range(0, xt.shape[0], chunk)]
    return torch.cat(out).to(torch.int32).cpu().numpy()
