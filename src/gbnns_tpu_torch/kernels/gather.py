"""Row gather: ``payload[idx]`` over whole rows, the graph walker's hop fetch.

Port of ``gbnns_tpu/kernels/gather_pallas.py`` (``dma_row_gather``, which
keeps its name and (n, S, 128) layout here beside ``row_gather``). Every
hop of the payload walker (``search/walker_payload.py``) fetches, for each
node it expands, one row holding the node's neighbour vectors and ids.
``row_gather`` launches kernel K3 (``csrc/gather.cu``) for CUDA tensors and
takes its plain version, ``row_gather_plain`` (``torch.index_select``), only
for CPU tensors. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from gbnns_tpu_torch.kernels import _build

launches = _build.LaunchCounts("row_gather")
reset_launches = launches.reset


def _library():
    lib = _build.load("gather")
    if not getattr(lib, "_gbnns_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gbnns_row_gather.argtypes = [p, p, p, i, i, i, p]
        lib.gbnns_row_gather.restype = i
        lib._gbnns_bound = True
    return lib


def _check_args(payload: torch.Tensor, idx: torch.Tensor,
                check_ids: bool) -> None:
    if payload.dtype != torch.float32 or payload.ndim != 2:
        raise ValueError(f"payload must be an (n, W) float32 container, got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    if payload.shape[1] % 4:
        raise ValueError(f"payload rows of {payload.shape[1]} words are not "
                         "a multiple of 16 bytes")
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise ValueError(f"idx must be (R,) int32, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if idx.device != payload.device:
        raise ValueError("payload and idx must lie on one device")
    if check_ids and idx.numel():
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= payload.shape[0]:
            raise IndexError(f"row ids must lie in [0, {payload.shape[0]}), "
                             f"got [{int(lo)}, {int(hi)}]")


def row_gather_plain(payload: torch.Tensor, idx: torch.Tensor, *,
                     check_ids: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``row_gather`` (same contract)."""
    _check_args(payload, idx, check_ids)
    return torch.index_select(payload, 0, idx)


def row_gather(payload: torch.Tensor, idx: torch.Tensor, *,
               check_ids: bool = True) -> torch.Tensor:
    """Rows ``payload[idx]``: ``(n, W)`` f32 x ``(R,)`` int32 → ``(R, W)``,
    bit for bit. ``W`` must be a multiple of 4 words (16 bytes).

    Ids outside ``[0, n)`` raise ``IndexError``; the check costs one device
    sync, so a caller that guarantees its ids (the walker, whose frontier
    ids are pool members or 0) passes ``check_ids=False``. CPU tensors take
    ``row_gather_plain``; CUDA tensors launch K3.
    """
    if payload.device.type == "cpu":
        return row_gather_plain(payload, idx, check_ids=check_ids)
    if payload.device.type != "cuda":
        raise ValueError(f"row_gather runs on cuda or cpu, not "
                         f"{payload.device}")
    _check_args(payload, idx, check_ids)
    payload = payload.contiguous()
    if payload.data_ptr() % 16:
        payload = payload.clone()
    idx = idx.contiguous()
    n, W = payload.shape
    out = torch.empty((idx.shape[0], W), dtype=torch.float32,
                      device=payload.device)
    lib = _library()
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        err = lib.gbnns_row_gather(payload.data_ptr(), idx.data_ptr(),
                                   out.data_ptr(), n, idx.shape[0], W * 4,
                                   stream)
    _build.check(lib, err, "row_gather")
    launches.count("row_gather")
    return out


def dma_row_gather(payload: torch.Tensor, idx: torch.Tensor, *,
                   interpret: bool = False) -> torch.Tensor:
    """``row_gather`` under the JAX package's name and layout, as its
    callers import it (``gather_pallas.dma_row_gather``): ``payload[idx]``
    of an (n, S, 128) f32 payload (S a multiple of 8, the Pallas kernel's
    tiling) and (R,) int32 ids → (R, S, 128), bit for bit, through K3 on a
    CUDA tensor. ``interpret`` is accepted and changes nothing."""
    if payload.ndim != 3 or payload.shape[2] != 128 or payload.shape[1] % 8:
        raise ValueError(f"payload rows must be (8k, 128)-tiled, got "
                         f"{tuple(payload.shape[1:])}")
    if payload.dtype != torch.float32:
        raise ValueError("payload must be float32-viewed (bitcast packing)")
    n, rows = payload.shape[0], payload.shape[1] * payload.shape[2]
    out = row_gather(payload.reshape(n, rows), idx)
    return out.view(idx.shape[0], *payload.shape[1:])
