"""Fused binned scan and top-c merge: the candidate stage of the fused engine.

Port of ``gbnns_tpu/kernels/scan_topk_pallas.py``. The scan scores every
corpus row in the reduced space and keeps, per bin of ``bin_size`` rows and
per query, only the bin's min score and its row, so the (B, n) score matrix
never reaches device memory. The merge then picks each query's ``c`` best
bin winners for the exact full-dimension re-rank.

Scores (smaller is closer; the per-query ``‖q‖²`` term cannot change a
query's ranking, so it is left out):

* bf16: the corpus is stored prescaled as ``-2x`` (l2) or ``-x`` (ip,
  angular), an exact exponent shift, and ``score = addvec[x] + x·q`` with
  ``addvec`` = ``‖x‖²`` (l2) or 0, and +inf on padding rows;
* int8: per-tensor corpus scale ``sx``, per-query scale ``sq``, exact int32
  dots and ``score = addvec[x] + dot * alpha[q]``, ``alpha = -2/(sx*sq)``
  (l2) or ``-1/(sx*sq)``; ``addvec`` is the norm of the dequantized corpus.

Each of ``binned_scan`` and ``merge_topc`` launches its CUDA kernel
(``csrc/scan_topk.cu``, K1 and K2) for CUDA tensors and takes its plain
PyTorch version (``binned_scan_plain``, ``merge_topc_plain``) only for CPU
tensors. ``launches`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels import _build
from gbnns_tpu_torch.kernels.distance import exact_fp32
from gbnns_tpu_torch.search.rerank import rerank

# Feature widths the scan kernel is built for; FusedScanIndex pads the
# reduced dimension up to one of them with zero columns (exact: zeros add
# nothing to a dot product).
SCAN_WIDTHS = (16, 32, 64, 128)
_INT_MAX = 0x7FFFFFFF

launches = {"binned_scan": 0, "merge_topc": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def _count_launch(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def scan_width(d: int) -> int:
    """The smallest kernel width that holds ``d`` reduced dimensions."""
    for w in SCAN_WIDTHS:
        if d <= w:
            return w
    raise ValueError(f"reduced dimension {d} > {SCAN_WIDTHS[-1]}: wider scans "
                     "are not built (see ROADMAP.md)")


def _flip(bits: torch.Tensor) -> torch.Tensor:
    """IEEE-f32 bits (as int32) -> signed-int total order; an involution."""
    return torch.where(bits < 0, bits ^ _INT_MAX, bits)


def _library():
    lib = _build.load("scan_topk")
    if not getattr(lib, "_gbnns_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gbnns_binned_scan.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.gbnns_binned_scan.restype = i
        lib.gbnns_merge_topc_stage.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gbnns_merge_topc_stage.restype = i
        lib.gbnns_error_string.argtypes = [i]
        lib.gbnns_error_string.restype = ctypes.c_char_p
        lib._gbnns_bound = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.gbnns_error_string(err).decode()}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_scan_args(q, x, addvec, alpha, bin_size, packed) -> bool:
    """Validate the scan's inputs; returns whether it is the int8 scan."""
    quant = x.dtype == torch.int8
    if x.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"scan corpus must be bfloat16 or int8, got {x.dtype}")
    if q.dtype != x.dtype:
        raise TypeError(f"queries {q.dtype} do not match corpus {x.dtype}")
    others = [q, addvec] + ([] if alpha is None else [alpha])
    if any(t.device != x.device for t in others):
        raise ValueError("scan inputs must all lie on one device")
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)}")
    if x.shape[0] % bin_size or tuple(addvec.shape) != (x.shape[0],):
        raise ValueError(f"corpus rows {x.shape[0]} must be a multiple of "
                         f"bin_size {bin_size}, with one addvec entry each")
    if packed and bin_size & (bin_size - 1):
        raise ValueError("packed selection needs a power-of-two bin_size")
    if quant != (alpha is not None):
        raise ValueError("alpha (per-query dequantization) goes with, and "
                         "only with, an int8 scan")
    return quant


def binned_scan_plain(q, x, addvec, alpha=None, *, bin_size: int = 1024,
                      packed: bool = False):
    """Plain PyTorch version of ``binned_scan`` (same contract).

    The dots run as fp32 products with TF32 off: exact products of bf16
    inputs, and exact integer sums for int8 (|dot| <= d * 127² < 2^24)."""
    quant = _check_scan_args(q, x, addvec, alpha, bin_size, packed)
    B = q.shape[0]
    n_bins = x.shape[0] // bin_size
    vals = torch.empty((n_bins, B), dtype=torch.float32, device=x.device)
    ids = torch.empty((n_bins, B), dtype=torch.int32, device=x.device)
    qf = q.float()
    mask = bin_size - 1
    # bound the f32 score block to 2^26 entries (256 MB)
    step = max(1, (1 << 26) // (B * bin_size))
    iota = torch.arange(bin_size, dtype=torch.int32, device=x.device)
    for b0 in range(0, n_bins, step):
        b1 = min(n_bins, b0 + step)
        r0, r1 = b0 * bin_size, b1 * bin_size
        with exact_fp32():
            dots = x[r0:r1].float() @ qf.T                    # (rows, B)
        add = addvec[r0:r1, None].float()
        s = add + dots * alpha[None, :] if quant else add + dots
        s = s.view(b1 - b0, bin_size, B)
        if packed:
            key = (_flip(s.view(torch.int32)) & ~mask) | iota[None, :, None]
            kmin = key.amin(dim=1)
            vals[b0:b1] = _flip(kmin & ~mask).view(torch.float32)
            pos = kmin & mask
        else:
            v, pos = s.min(dim=1)                  # first min: lower row
            vals[b0:b1] = v
        base = torch.arange(b0, b1, device=x.device, dtype=torch.int64)
        ids[b0:b1] = (pos + base[:, None] * bin_size).to(torch.int32)
    return vals, ids


def binned_scan(q, x, addvec, alpha=None, *, bin_size: int = 1024,
                packed: bool = False):
    """Bin winners of the full scan, bin-major: ``(vals (n_bins, B) f32,
    ids (n_bins, B) int32)``, ids being corpus rows.

    q (B, d) and x (n_pad, d) are both bfloat16 (x prescaled) or both int8;
    addvec (n_pad,) f32; alpha (B,) f32 for int8 only. ``packed`` selects on
    an int key with the score quantized to 2^-13 relative (ties to the lower
    row). CPU tensors take ``binned_scan_plain``; CUDA tensors launch K1.
    """
    if x.device.type == "cpu":
        return binned_scan_plain(q, x, addvec, alpha, bin_size=bin_size,
                                 packed=packed)
    quant = _check_scan_args(q, x, addvec, alpha, bin_size, packed)
    if x.device.type != "cuda":
        raise ValueError(f"binned_scan runs on cuda or cpu, not {x.device}")
    B, d = q.shape
    if d not in SCAN_WIDTHS:
        raise ValueError(f"the scan kernel takes d in {SCAN_WIDTHS}, got {d}")
    q, x = _aligned(q), _aligned(x)
    addvec = _aligned(addvec.float())
    alpha = _aligned(alpha.float()) if quant else None
    n_bins = x.shape[0] // bin_size
    vals = torch.empty((n_bins, B), dtype=torch.float32, device=x.device)
    ids = torch.empty((n_bins, B), dtype=torch.int32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gbnns_binned_scan(
            q.data_ptr(), x.data_ptr(), addvec.data_ptr(),
            alpha.data_ptr() if quant else None, vals.data_ptr(),
            ids.data_ptr(), B, x.shape[0], d, bin_size, int(quant),
            int(packed), stream)
    _check(lib, err, "binned_scan")
    _count_launch("binned_scan")
    return vals, ids


def _merge_plan(c: int, rb: int, rows: int) -> tuple[int, int, bool]:
    """(ck, rb, exact_fallback) exactly as the Pallas merge_topc decides:
    c rounded up to 8; rb raised to the next power of two when 2*ck > rb;
    an exact merge when rb would pass 2048 or no reduction is left."""
    ck = _round_up(max(c, 8), 8)
    if ck * 2 > rb:
        rb = 1 << (ck * 2 - 1).bit_length()
    return ck, rb, rb > 2048 or c >= rows


def exact_topc(vals, ids, c: int):
    """Exact top-c of bin-major winners: ``(vals (B, c'), ids (B, c'))``
    ascending, c' = min(c, n_bins); ties go to the lower bin."""
    cc = min(c, vals.shape[0])
    v, order = torch.sort(vals.T, dim=1, stable=True)
    return v[:, :cc], torch.gather(ids.T, 1, order[:, :cc])


def _merge_stage_plain(vals, ids, ck: int, rb: int):
    R, B = vals.shape
    nb = -(-R // rb)
    pad = nb * rb - R
    if pad:
        vals = torch.cat([vals, vals.new_full((pad, B), float("inf"))])
        ids = torch.cat([ids, ids.new_full((pad, B), -1)])
    mask = rb - 1
    iota = torch.arange(rb, dtype=torch.int32, device=vals.device)
    keys = ((_flip(vals.contiguous().view(torch.int32)) & ~mask)
            .view(nb, rb, B) | iota[None, :, None])
    ids = ids.reshape(nb, rb, B)
    out_v = vals.new_empty((nb, ck, B))
    out_i = ids.new_empty((nb, ck, B))
    for t in range(ck):
        kmin = keys.amin(dim=1)                                   # (nb, B)
        row = (kmin & mask).long()[:, None, :]
        out_v[:, t] = _flip(kmin & ~mask).view(torch.float32)
        out_i[:, t] = torch.gather(ids, 1, row)[:, 0]
        keys.scatter_(1, row, _INT_MAX)
    return out_v.view(nb * ck, B), out_i.view(nb * ck, B)


def merge_topc_plain(vals, ids, c: int, *, rb: int = 512):
    """Plain PyTorch version of ``merge_topc`` (same contract and stages)."""
    ck, rb, fallback = _merge_plan(c, rb, vals.shape[0])
    if fallback:
        return exact_topc(vals, ids, c)
    while True:
        vals, ids = _merge_stage_plain(vals, ids, ck, rb)
        if vals.shape[0] == ck:
            return vals[:c].T, ids[:c].T


def merge_topc(vals, ids, c: int, *, rb: int = 512):
    """Top-c merge of bin-major winners ``vals/ids (R, B)`` (from
    ``binned_scan``) → ``(vals (B, c) f32, ids (B, c) int32)``, ascending by
    the quantized key.

    Hierarchical, as in the Pallas version: each stage reduces blocks of
    ``rb`` rows to their top ck = round_up(c, 8) by flipped-IEEE keys with
    the in-block row in the low log2(rb) bits, until one block remains.
    Values come back quantized to 2^-(23 - log2 rb) relative; padding slots
    carry +inf and id -1. Past rb = 2048, or when c >= R, the merge is an
    exact sort instead. CPU tensors take ``merge_topc_plain``; CUDA tensors
    launch K2 once per stage.
    """
    if vals.device.type == "cpu":
        return merge_topc_plain(vals, ids, c, rb=rb)
    if vals.device.type != "cuda":
        raise ValueError(f"merge_topc runs on cuda or cpu, not {vals.device}")
    if vals.dtype != torch.float32 or ids.dtype != torch.int32 \
            or vals.shape != ids.shape or vals.ndim != 2:
        raise ValueError("merge_topc takes f32 vals and int32 ids of one "
                         "(R, B) shape")
    ck, rb, fallback = _merge_plan(c, rb, vals.shape[0])
    if fallback:
        return exact_topc(vals, ids, c)
    lib = _library()
    B = vals.shape[1]
    vals, ids = vals.contiguous(), ids.contiguous()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        while True:
            R = vals.shape[0]
            rows = ck * (-(-R // rb))
            out_v = torch.empty((rows, B), dtype=torch.float32,
                                device=vals.device)
            out_i = torch.empty((rows, B), dtype=torch.int32,
                                device=vals.device)
            err = lib.gbnns_merge_topc_stage(
                vals.data_ptr(), ids.data_ptr(), out_v.data_ptr(),
                out_i.data_ptr(), R, B, rb, ck, stream)
            _check(lib, err, "merge_topc")
            _count_launch("merge_topc")
            vals, ids = out_v, out_i
            if rows == ck:
                return vals[:c].T, ids[:c].T


class FusedScanIndex:
    """Flat index whose candidate scan is the fused binned scan.

    Same contract as ``search.flat.FlatIndex`` (reduced-space scan, then an
    exact full-dimension re-rank), but the scan never writes scores to
    device memory. ``c`` (the re-rank pool) is the recall knob.

    ``chunk`` only rounds the corpus up (n_pad = round_up(n, chunk)); it sets
    the count of padding bins, as in the Pallas version.
    """

    def __init__(self, base_full, base_lo=None, *, metric: str = "l2",
                 scan_dtype="bfloat16", bin_size: int = 1024,
                 chunk: int = 16384, packed: bool = False,
                 mode: str = "binned", rerank_dtype=torch.float32,
                 device=None):
        if metric not in ("l2", "ip", "angular"):
            raise ValueError(f"unknown metric {metric!r}")
        if mode == "shifted":
            raise NotImplementedError(
                "mode='shifted' needs the shifted-key scan kernel (T3), "
                "still to be ported: see ROADMAP.md")
        if mode != "binned":
            raise ValueError(f"unknown mode {mode!r}")
        if scan_dtype in ("int8", torch.int8):
            self.quant = True
        elif scan_dtype in ("bfloat16", torch.bfloat16):
            self.quant = False
        else:
            raise ValueError(f"scan_dtype must be bfloat16 or int8, "
                             f"got {scan_dtype!r}")
        if rerank_dtype in ("float32", torch.float32):
            rerank_dtype = torch.float32
        elif rerank_dtype in ("bfloat16", torch.bfloat16):
            rerank_dtype = torch.bfloat16
        else:
            raise ValueError(f"rerank_dtype must be float32 or bfloat16, "
                             f"got {rerank_dtype!r}")
        self.device = resolve_device(device)
        self.metric = metric
        self.packed = packed
        self.chunk = chunk
        base_full = np.asarray(base_full, np.float32)
        lo = base_full if base_lo is None else np.asarray(base_lo, np.float32)
        n, d_lo = lo.shape
        self.n = n
        n_pad = _round_up(n, chunk)
        # small-corpus guard: one winner per bin caps the candidate pool at
        # n/bin_size, so keep >= ~128 real bins (results change with it)
        cap = max(8, 1 << max(3, (n // 128).bit_length() - 1))
        self.bin_size = bin_size = min(bin_size, cap)
        if n_pad % bin_size:
            raise ValueError(f"chunk {chunk} must be a multiple of the bin "
                             f"size {bin_size}")
        width = scan_width(d_lo)
        lo_pad = np.zeros((n_pad, width), np.float32)
        lo_pad[:n, :d_lo] = lo
        if metric == "l2":
            add = (lo_pad ** 2).sum(-1)
            add[n:] = np.inf
            self.dot_scale = -2.0
        else:
            add = np.zeros(n_pad, np.float32)
            add[n:] = np.inf
            self.dot_scale = -1.0
        if self.quant:
            # symmetric per-tensor int8; addvec from the DEQUANTIZED corpus
            # so scores are exact distances of what is stored
            self.sx = float(127.0 / (np.abs(lo).max() or 1.0))
            xi = np.clip(np.rint(lo_pad * self.sx), -127, 127)
            if metric == "l2":
                xq = xi[:n] / self.sx
                add[:n] = (xq * xq).sum(-1)
            self.x_lo = torch.from_numpy(xi.astype(np.int8)).to(self.device)
        else:
            # prescaled storage: -2x / -x is exact in bf16
            self.x_lo = (torch.from_numpy(self.dot_scale * lo_pad)
                         .to(torch.bfloat16).to(self.device))
        self.d_lo = d_lo
        self.addvec = torch.from_numpy(add.astype(np.float32)).to(self.device)
        # bf16 re-rank halves the candidate gather; the norms stay f32 and
        # are taken before the cast
        bf = torch.from_numpy(base_full).to(self.device)
        self.base_sq = (bf * bf).sum(-1)
        self.base_full = bf.to(rerank_dtype)

    def scan_queries(self, ql: torch.Tensor):
        """Queries in the scan's type and width, and the int8 dequant
        factor per query (None for bf16)."""
        width = self.x_lo.shape[1]
        if ql.shape[1] != self.d_lo:
            raise ValueError(f"queries have {ql.shape[1]} reduced dims, the "
                             f"index {self.d_lo}")
        if width != self.d_lo:
            ql = torch.nn.functional.pad(ql, (0, width - self.d_lo))
        if not self.quant:
            return ql.to(torch.bfloat16), None
        # per-query symmetric int8: a positive per-query scale on the dot
        # term cannot change that query's ranking
        sq = 127.0 / torch.clamp(ql.abs().amax(dim=1), min=1e-30)
        q8 = torch.clamp(torch.round(ql * sq[:, None]), -127, 127)
        return q8.to(torch.int8), self.dot_scale / (self.sx * sq)

    def candidates(self, queries_lo, *, c: int = 32,
                   merge: str | None = None) -> torch.Tensor:
        """Re-rank candidate pool: (B, <=c) int32 corpus ids, best
        (quantized) reduced score first.

        ``merge``: "pallas" (kernel K2 over the bin-major winners), "exact"
        (a sort of the transposed winners), "approx" (the same exact sort:
        the TPU's approximate top-k has no counterpart here), or None:
        "pallas" on the card and "exact" on the CPU."""
        if merge is None:
            merge = "pallas" if self.device.type == "cuda" else "exact"
        if merge not in ("pallas", "exact", "approx"):
            raise ValueError(f"unknown merge {merge!r}")
        ql = torch.as_tensor(queries_lo, dtype=torch.float32,
                             device=self.device)
        q_scan, alpha = self.scan_queries(ql)
        vals, ids = binned_scan(q_scan, self.x_lo, self.addvec, alpha,
                                bin_size=self.bin_size, packed=self.packed)
        cc = min(c, vals.shape[0])
        if merge == "pallas":
            return merge_topc(vals, ids, cc)[1]
        return exact_topc(vals, ids, cc)[1]

    def search(self, queries_full, queries_lo=None, *, k: int = 10,
               c: int = 32, merge: str | None = None):
        """Top-k ``(ids (B, k) int32, dists (B, k) f32)`` after the exact
        full-dimension re-rank of the ``c`` scan candidates."""
        qf = torch.as_tensor(queries_full, dtype=torch.float32,
                             device=self.device)
        ql = qf if queries_lo is None else queries_lo
        cand = self.candidates(ql, c=c, merge=merge)
        return rerank(qf, self.base_full, cand, k, metric=self.metric,
                      base_sqnorms=self.base_sq)


def scan_agreement(got, ref, q, x, addvec, alpha=None, *, bin_size: int,
                   packed: bool, rtol: float = 1e-5) -> dict:
    """Hold a scan's bin winners ``got = (vals, ids)`` against the plain
    version's ``ref`` on the same inputs.

    Values must agree within ``rtol`` (relative to the largest |ref| value,
    since a score near 0 is the difference of larger terms); in packed mode
    within one quantum of the key as well. Ids must be equal, except at a
    near-tie: the plain score at the kernel's row lies within the same
    tolerance of the bin's min. Returns the counts and the largest error;
    ``ok`` says whether every bin passed."""
    gv, gi = got[0].float(), got[1].long()
    rv, ri = ref[0].float(), ref[1].long()
    scale = rv[torch.isfinite(rv)].abs().max().item() if rv.numel() else 1.0
    tol = rtol * max(scale, 1e-30)
    if packed:
        tol += 2.0 ** (int(np.log2(bin_size)) - 22) * max(scale, 1e-30)
    both_inf = torch.isinf(gv) & torch.isinf(rv) & (gv == rv)
    err = torch.where(both_inf, torch.zeros_like(gv), (gv - rv).abs())
    max_err = err.max().item() if err.numel() else 0.0
    bad_vals = int((err > tol).sum())
    miss = (gi != ri).nonzero()
    near_ties = 0
    if miss.numel():
        b, j = miss[:, 0], miss[:, 1]
        rows = gi[b, j]
        dots = (x[rows].float() * q[j].float()).sum(-1)
        s = addvec[rows].float() + (dots * alpha[j].float()
                                    if alpha is not None else dots)
        near_ties = int(((s - rv[b, j]).abs() <= tol).sum())
    id_bad = int(miss.shape[0]) - near_ties
    return {"max_abs_err": max_err, "bad_values": bad_vals,
            "id_mismatches": int(miss.shape[0]), "near_ties": near_ties,
            "ok": bad_vals == 0 and id_bad == 0}
