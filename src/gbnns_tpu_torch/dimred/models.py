"""Dimensionality-reduction projection models.

A linear d→d' projection and a small MLP variant, with an angular
(normalized) flavour, as ``nn.Module``s. One forward serves corpus
projection and query projection at search time. The public functions keep
the JAX package's layout: a projection kernel is (d_in, d_out), and
``dimred.train.params_from_jax`` maps it onto ``nn.Linear``'s transposed
weight.
"""

from __future__ import annotations

import torch
from torch import nn


def _normalize(y: torch.Tensor) -> torch.Tensor:
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                           min=1e-12)


class LinearProjection(nn.Module):
    """x @ W, W: (d_in, d_out), no bias. ``normalize=True`` L2-normalizes
    outputs so the reduced space keeps angular/IP geometry."""

    def __init__(self, d_in: int, d_out: int, *, normalize: bool = False):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out, bias=False)
        self.normalize = normalize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x)
        return _normalize(y) if self.normalize else y


class MLPProjection(nn.Module):
    """Dense → ReLU → Dense (no bias) nonlinear reduction."""

    def __init__(self, d_in: int, d_out: int, *, hidden: int = 512,
                 normalize: bool = False):
        super().__init__()
        self.hidden = nn.Linear(d_in, hidden)
        self.proj = nn.Linear(hidden, d_out, bias=False)
        self.normalize = normalize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(torch.relu(self.hidden(x)))
        return _normalize(y) if self.normalize else y


def make_model(kind: str, d_in: int, d_out: int, *, hidden: int = 512,
               normalize: bool = False) -> nn.Module:
    if kind == "linear":
        return LinearProjection(d_in, d_out, normalize=normalize)
    if kind == "mlp":
        return MLPProjection(d_in, d_out, hidden=hidden, normalize=normalize)
    raise ValueError(f"unknown projection model {kind!r} (want 'linear'|'mlp')")
