"""Exact fused kNN: fp32 distance tiles and a running top-k per query.

Port of ``gbnns_tpu.kernels.distance_topk_pallas.knn_pallas`` (the file name
drops "pallas", as ``search/walker_payload.py`` does). No module of the JAX
package calls it, and ``build_knn_graph(backend="pallas")`` refuses it: it
is the exact oracle of the JAX package's kernel tests and its build A/B, and
a direct call here.

Distances, smaller is closer: l2 ``‖q‖² − 2q·x + ‖x‖²`` in that form (no
clamp at 0, as in the Pallas kernel), ip and angular ``−q·x``, with fp32
products and sums whatever the input type (f32 or bf16). Each query gets
its ``k`` smallest in ascending order, ties to the lower row: the Pallas
kernel puts the running best list in front of each tile and extracts the
first position of the minimum, which is (value, row) order.

``knn_topk`` launches the CUDA kernel T6 (``csrc/distance_topk.cu``) for
CUDA tensors and takes ``knn_topk_plain`` only for CPU tensors;
``launches["knn_topk"]`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from gbnns_tpu_torch.kernels import _build
from gbnns_tpu_torch.kernels.distance import METRICS, exact_fp32
from gbnns_tpu_torch.kernels.topk import _smallest, smallest_k

# Query widths the kernel is built for; a narrower d is padded with zero
# columns (exact: they add nothing to a dot product or a norm).
KNN_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128)
KNN_MAX_K = 128
_KNN_MAX_SPLITS = 64
_DTYPES = (torch.bfloat16, torch.float32)
_BLOCK_QUERIES = 64   # the kernel's kQt
_TILE_ROWS = 256      # its corpus tile, kRt

launches = _build.LaunchCounts("knn_topk")
reset_launches = launches.reset


def _library():
    lib = _build.load("distance_topk")
    if not getattr(lib, "_gbnns_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gbnns_knn_topk.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.gbnns_knn_topk.restype = i
        lib.gbnns_knn_blocks_per_sm.argtypes = [i, i, p]
        lib.gbnns_knn_blocks_per_sm.restype = i
        lib._gbnns_bound = True
    return lib


def _check_args(q, x, k: int, metric: str, n_valid: int | None) -> int:
    """The Pallas ``knn_pallas``'s checks; returns the corpus size n."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    for t in (q, x):
        if t.dtype not in _DTYPES:
            raise TypeError(f"knn_topk takes float32 or bfloat16 inputs, "
                            f"got {t.dtype}")
    if q.device != x.device:
        raise ValueError("knn_topk inputs must lie on one device")
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)}")
    n = x.shape[0] if n_valid is None else n_valid
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    return n


def _distances(qf, xf, qsq, xsq, metric: str):
    """(nq, cols) distances of the Pallas kernel's form from f32 inputs."""
    with exact_fp32():
        dots = qf @ xf.T
    if metric == "l2":
        return qsq[:, None] - 2.0 * dots + xsq[None, :]
    return -dots


def knn_topk_plain(q, x, k: int, *, metric: str = "l2",
                   n_valid: int | None = None):
    """Plain PyTorch version of ``knn_topk`` (same contract): fp32 products
    with TF32 off over corpus blocks of at most 2^26 distances, each block
    reduced by ``smallest_k`` and merged into the running best list in
    (value, row) order."""
    n = _check_args(q, x, k, metric, n_valid)
    qf, xf = q.float(), x[:n].float()
    qsq, xsq = (qf * qf).sum(-1), (xf * xf).sum(-1)
    nq = q.shape[0]
    best_d = torch.full((nq, k), float("inf"), device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    step = max(k, (1 << 26) // max(nq, 1))
    for off in range(0, n, step):
        d = _distances(qf, xf[off:off + step], qsq, xsq[off:off + step],
                       metric)
        cd, ci = smallest_k(d, min(k, d.shape[1]))
        best_d, best_i = _smallest(torch.cat([best_d, cd], 1),
                                   torch.cat([best_i, ci + off], 1), k)
    return best_d, best_i.to(torch.int32)


def _blocks_per_sm(lib, width: int, k: int) -> int:
    """The kernel's blocks resident a multiprocessor of the current device
    at this width and k (its shared memory grows with both)."""
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.gbnns_knn_blocks_per_sm(width, k,
                                                  ctypes.byref(blocks)),
                 "knn_topk occupancy")
    return blocks.value


def _splits(lib, nq: int, n: int, width: int, k: int,
            device: torch.device) -> tuple[int, int]:
    """Corpus splits across the kernel's blocks of 64 queries: as many as
    fill the card once at the blocks its launch geometry keeps resident a
    streaming multiprocessor (every split costs each query a first tile
    and about k · ln(rows / k) candidates), each split at least 256 rows
    and a whole number of the kernel's 256-row tiles. Returns (splits,
    rows_per_split)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_blocks = -(-nq // _BLOCK_QUERIES)
    per_sm = _blocks_per_sm(lib, width, k)
    splits = max(1, min(_KNN_MAX_SPLITS, per_sm * sms // q_blocks,
                        -(-n // _TILE_ROWS)))
    rows = -(-n // splits)
    rows = -(-rows // _TILE_ROWS) * _TILE_ROWS
    return -(-n // rows), rows


def knn_topk(q, x, k: int, *, metric: str = "l2", qt: int = 256,
             xt: int = 1024, n_valid: int | None = None):
    """Exact kNN of ``q (nq, d)`` against ``x (n, d)``, both float32 or
    bfloat16 (a bf16 and an f32 input take f32): ``(dists (nq, k) f32
    ascending, ids (nq, k) int32)``, ties to the lower id. ``n_valid``: the
    logical corpus size when ``x`` is already padded; rows past it are
    never selected. ``qt`` and ``xt`` are the Pallas kernel's tiles,
    accepted and changing no result.

    CPU tensors take ``knn_topk_plain``; CUDA tensors launch T6 (d <= 128,
    k <= ``KNN_MAX_K``)."""
    if q.device.type == "cpu":
        return knn_topk_plain(q, x, k, metric=metric, n_valid=n_valid)
    n = _check_args(q, x, k, metric, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"knn_topk runs on cuda or cpu, not {q.device}")
    nq, d = q.shape
    if k > KNN_MAX_K:
        raise ValueError(f"the knn_topk kernel takes k <= {KNN_MAX_K}, "
                         f"got {k}")
    width = next((w for w in KNN_WIDTHS if d <= w), None)
    if width is None:
        raise ValueError(f"the knn_topk kernel takes d <= {KNN_WIDTHS[-1]}, "
                         f"got {d}")
    # f32 operands (bf16 widened exactly), zero columns up to the width, the
    # corpus transposed (width, ldx) so that its tiles arrive column-major
    qf, xf = q.float(), x[:n].float()
    qsq = (qf * qf).sum(-1).contiguous()
    ldx = -(-n // 4) * 4
    xsq = torch.zeros(ldx, dtype=torch.float32, device=q.device)
    xsq[:n] = (xf * xf).sum(-1)
    qf = _build.aligned(torch.nn.functional.pad(qf, (0, width - d)))
    xt = torch.zeros((width, ldx), dtype=torch.float32, device=q.device)
    xt[:d, :n] = xf.T
    del xf
    lib = _library()
    with torch.cuda.device(q.device):
        splits, rows = _splits(lib, nq, n, width, k, q.device)
    part_d = torch.empty((nq, splits, k), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=q.device)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.gbnns_knn_topk(
            qf.data_ptr(), xt.data_ptr(), qsq.data_ptr(), xsq.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), nq, n, ldx, width, k, splits, rows,
            int(metric == "l2"), stream)
    _build.check(lib, err, "knn_topk")
    launches.count("knn_topk")
    return out_d, out_i


def knn_pallas(q, x, k: int, *, metric: str = "l2", qt: int = 256,
               xt: int = 1024, interpret: bool = False,
               n_valid: int | None = None):
    """``knn_topk`` under the JAX package's name and keywords, as its callers
    import it (``distance_topk_pallas.knn_pallas``); ``interpret`` is
    accepted and changes nothing."""
    return knn_topk(q, x, k, metric=metric, qt=qt, xt=xt, n_valid=n_valid)


def knn_agreement(got, ref, q, x, *, metric: str = "l2",
                  rtol: float = 1e-5) -> dict:
    """Hold a kNN result ``got = (dists, ids)`` against ``ref`` on the same
    inputs ``q``, ``x``.

    Distances must agree within ``rtol`` of the largest |ref| distance (a
    distance near 0 is the difference of larger terms). Ids must be equal,
    except at a near-tie: the float64 distances of the two ids agree within
    that tolerance. Returns the counts and the largest error; ``ok`` says
    whether every slot passed."""
    gd, gi = got[0].float(), got[1].long()
    rd, ri = ref[0].float(), ref[1].long()
    finite = rd[torch.isfinite(rd)]
    tol = rtol * max(finite.abs().max().item() if finite.numel() else 1.0,
                     1e-30)
    err = (gd - rd).abs()
    max_err = err.max().item() if err.numel() else 0.0
    bad_vals = int((err > tol).sum())
    miss = (gi != ri).nonzero()
    near_ties = 0
    if miss.numel():
        r, c = miss[:, 0], miss[:, 1]
        qd = q[r].double()

        def exact(ids):
            xd = x[ids[r, c]].double()
            if metric == "l2":
                return ((qd - xd) ** 2).sum(-1)
            return -(qd * xd).sum(-1)

        near_ties = int(((exact(gi) - exact(ri)).abs() <= tol).sum())
    id_bad = int(miss.shape[0]) - near_ties
    return {"max_abs_err": max_err, "bad_values": bad_vals,
            "id_mismatches": int(miss.shape[0]), "near_ties": near_ties,
            "ok": bad_vals == 0 and id_bad == 0}
