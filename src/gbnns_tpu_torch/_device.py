"""Device selection for the port's entry points.

Every entry point takes ``device=None`` and runs on the card: ``None``
means ``"cuda"``. Without a CUDA device the call raises instead of carrying
on on the CPU; the CPU runs only when the caller asks for it (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # an explicit index, so threads can select the same card
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
