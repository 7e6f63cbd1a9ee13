"""PCA: the classical linear reduction the learned projection is compared
with, and the trainer's starting point.

Port of ``gbnns_tpu/dimred/pca.py``. The covariance is accumulated over row
chunks in full fp32 (TF32 off) on the device, then the (d, d) matrix is
decomposed with ``torch.linalg.eigh``; no O(n d^2) host SVD.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import exact_fp32


@dataclasses.dataclass
class PCAModel:
    mean: np.ndarray                # (d,)
    components: np.ndarray          # (d, d_out), columns = principal axes
    explained_variance: np.ndarray  # (d_out,)


@torch.no_grad()
def pca_fit(x, d_out: int, *, chunk: int = 262144, device=None) -> PCAModel:
    """The top ``d_out`` principal axes of ``x (n, d)``, largest variance
    first. The mean is summed in float64 on the host, as in the JAX
    module."""
    dev = resolve_device(device)
    x = np.asarray(x)
    n, d = x.shape
    if d_out > d:
        raise ValueError(f"d_out={d_out} > d={d}")
    mean = np.zeros(d, np.float64)
    for off in range(0, n, chunk):
        mean += x[off:off + chunk].astype(np.float64).sum(0)
    mean /= n
    mean32 = torch.tensor(mean, dtype=torch.float32, device=dev)

    cov = torch.zeros((d, d), dtype=torch.float32, device=dev)
    with exact_fp32():
        for off in range(0, n, chunk):
            xc = torch.from_numpy(np.ascontiguousarray(
                x[off:off + chunk], np.float32)).to(dev) - mean32
            cov += xc.T @ xc
    cov /= n - 1

    evals, evecs = torch.linalg.eigh(cov)  # ascending
    order = torch.argsort(-evals, stable=True)[:d_out]
    return PCAModel(mean=mean.astype(np.float32),
                    components=evecs[:, order].cpu().numpy(),
                    explained_variance=evals[order].cpu().numpy())


@torch.no_grad()
def pca_transform(model: PCAModel, x, *, normalize: bool = False,
                  device=None) -> np.ndarray:
    """(n, d) → (n, d_out) in full fp32; ``normalize`` L2-normalizes the
    rows for angular metrics."""
    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    mean = torch.from_numpy(np.asarray(model.mean, np.float32)).to(dev)
    comps = torch.from_numpy(np.ascontiguousarray(model.components,
                                                  np.float32)).to(dev)
    with exact_fp32():
        y = (xt - mean[None, :]) @ comps
    if normalize:
        y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                            min=1e-12)
    return y.cpu().numpy()
