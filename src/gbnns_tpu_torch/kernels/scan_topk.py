"""Fused binned scan and top-c merge: the candidate stage of the fused engine.

Port of ``gbnns_tpu/kernels/scan_topk_pallas.py``. The scan scores every
corpus row in the reduced space and keeps, per bin of ``bin_size`` rows and
per query, only the bin's min score and its row, so the (B, n) score matrix
never reaches device memory. The merge then picks each query's ``c`` best
bin winners for the exact full-dimension re-rank.

``binned_scan`` takes the Pallas ``binned_scan``'s arguments, with its
meanings and defaults. Scores (smaller is closer; the per-query ``‖q‖²``
term cannot change a query's ranking, so it is left out unless a shift
puts it back), ``addvec`` being ``‖x‖²`` (l2) or 0, and +inf on padding
rows:

* bf16, fp16 and f32, ``prescaled=True``: the corpus is stored as ``-2x``
  (l2) or ``-x`` (ip, angular), an exact exponent shift, and ``score =
  addvec[x] + x·q`` (every engine of the port scans so);
* ``prescaled=False``: ``addvec[x] - 2 x·q`` (l2) or ``addvec[x] - x·q``
  (any other metric);
* ``qshift`` (B,) on a float kind: ``score + qshift[q]`` (``‖q‖²`` for l2,
  an upper bound for ip), added before the selection, so that scores are
  >= ~0 and the packed key drops its sign flip;
* int8 (``quant=True``): per-tensor corpus scale ``sx``, per-query scale
  ``sq``, exact int32 dots and ``score = addvec[x] + dot * alpha[q]``,
  ``alpha = qshift = -2/(sx*sq)`` (l2) or ``-1/(sx*sq)``; ``addvec`` is the
  norm of the dequantized corpus.

The shifted-key scan (``FusedScanIndex(mode="shifted")``, ``shifted_scan``)
folds the whole distance into one product of augmented operands
(``augment_corpus``, ``augment_queries``): ``‖x‖² − 2q·x + ‖q‖²`` (l2) or
``C_q − q·x`` (ip), non-negative but for rounding, so the raw IEEE bits order
as signed ints and the packed key needs no flip.

The cluster-gated scan of ``search/gated.py`` (``gated_topm_scan``) scores
only the (corpus chunk x query tile) cells its tile mask keeps, and gives
each query the ``m`` best fine-bin winners of each kept chunk.

Each of ``binned_scan``, ``merge_topc``, ``shifted_scan`` and
``gated_topm_scan`` launches its CUDA kernel (``csrc/scan_topk.cu``: K1 and
K2; ``csrc/shifted_scan.cu``: T3; ``csrc/gated_topm.cu``: T4) for CUDA
tensors and takes its plain PyTorch version (``binned_scan_plain``,
``merge_topc_plain``, ``shifted_scan_plain``, ``gated_topm_scan_plain``)
only for CPU tensors. ``launches`` counts the kernel launches of each
wrapper. K1, T3 and T4 run on the tensor cores or on the CUDA cores, as
``scan_cores``, ``shifted_cores`` and ``gated_cores`` decide from the kind
and the shape (there is no fallback from one to the other);
``launches_by_cores`` counts their launches by route.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels import _build
from gbnns_tpu_torch.kernels.distance import exact_fp32
from gbnns_tpu_torch.search.rerank import rerank

# Feature widths the register-resident scan kernels are built for; a wider
# reduced dimension takes the wide kernels at any multiple of 16, and any
# other width is padded with zero columns to ``scan_width`` (exact: zeros
# add nothing to a dot product). The indexes store padded corpora.
SCAN_WIDTHS = (16, 32, 64, 128)
# The scan's element type -> the ``kind`` of the C interface.
_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2,
          torch.float16: 3}
_INT_MAX = 0x7FFFFFFF

launches = _build.LaunchCounts("binned_scan", "merge_topc", "shifted_scan",
                               "gated_topm")
launches_by_cores = _build.LaunchCounts(
    "binned_scan:tensor", "binned_scan:cuda", "shifted_scan:tensor",
    "shifted_scan:cuda", "gated_topm:tensor", "gated_topm:cuda")


def reset_launches() -> None:
    """Set every launch count (and the per-route counts) to 0."""
    launches.reset()
    launches_by_cores.reset()


# The tensor-core scans run 16 corpus rows a product (mma.sync's M), so a
# bin must be a multiple of that; T3's tensor-core kernel holds its query
# fragments in registers up to this augmented width, and stages them in
# shared memory past it (as K1 does past SCAN_WIDTHS).
TC_ROW_TILE = 16
SHIFTED_TC_MAX_WIDTH = 264
_TC_KINDS = (torch.bfloat16, torch.float16, torch.int8)


def _as_dtype(kind) -> torch.dtype:
    return getattr(torch, kind) if isinstance(kind, str) else kind


def scan_cores(kind, d: int, bin_size: int) -> str:
    """Which K1 kernel a scan of element type ``kind`` (a torch dtype or its
    name) at width ``d`` and ``bin_size`` launches: "tensor" (bf16, fp16 and
    int8 at any d, bins a multiple of ``TC_ROW_TILE``: the query fragments
    in registers at ``scan_width(d)`` in ``SCAN_WIDTHS``, both operands
    staged in shared memory past it) or "cuda" (f32, whose tensor-core form
    TF32 would change the result; other bins)."""
    if _as_dtype(kind) in _TC_KINDS and bin_size % TC_ROW_TILE == 0:
        return "tensor"
    return "cuda"


def shifted_cores(kind, d_aug: int, bin_size: int = 1024) -> str:
    """Which T3 kernel a shifted scan launches: "tensor" (bf16 and fp16 at
    any d_aug, padded to ``shifted_width(d_aug)``: the query fragments in
    registers up to ``SHIFTED_TC_MAX_WIDTH``, in shared memory past it;
    bins a multiple of ``TC_ROW_TILE``) or "cuda" (f32, and bins under the
    row tile)."""
    if (_as_dtype(kind) in (torch.bfloat16, torch.float16) and d_aug > 0
            and bin_size % TC_ROW_TILE == 0):
        return "tensor"
    return "cuda"


def tc_warp_queries(d: int) -> int:
    """Queries a warp of a tensor-core scan holds at width ``d`` (bf16 or
    fp16 rows of d/16 k-slabs): 8 per n-tile, 64 up to d = 32, then 32 and
    16. Mirrors ``8 * TcShape::NT`` in ``csrc/common.cuh``; the gated
    library reports its own as ``gbnns_gated_warp_queries``, and a card
    test holds the two equal."""
    ks = d // 16
    return 8 * (8 if ks <= 2 else 16 // ks)


def gated_cores(kind, d: int, *, fine: int, tq: int) -> str:
    """Which T4 kernel a gated scan launches: "tensor" (bf16 and fp16 at d
    in ``SCAN_WIDTHS``, ``fine`` a multiple of ``TC_ROW_TILE`` and ``tq`` a
    multiple of a warp's queries, ``tc_warp_queries``, so that no warp
    straddles two mask tiles) or "cuda" (f32, whose tensor-core form TF32
    would change the result; fine 4 and 8; a tq that splits a warp; d off
    ``SCAN_WIDTHS``: past 128 the wide CUDA-core kernel). ``d`` is the
    width the kernel receives (``gated_topm_scan`` asks at
    ``scan_width(d)``). ``sub`` does not enter: any sub serves both."""
    if (_as_dtype(kind) in (torch.bfloat16, torch.float16)
            and d in SCAN_WIDTHS and fine % TC_ROW_TILE == 0
            and tq % tc_warp_queries(d) == 0):
        return "tensor"
    return "cuda"


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def scan_width(d: int) -> int:
    """The smallest kernel width that holds ``d`` reduced dimensions: one of
    ``SCAN_WIDTHS``, or ``d`` rounded up to 16 past the last of them."""
    for w in SCAN_WIDTHS:
        if d <= w:
            return w
    return _round_up(d, 16)


def _pad_columns(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (rows, d) with zero columns up to ``width`` (a copy; ``t``
    itself when d is width already)."""
    d = t.shape[1]
    return t if d == width else torch.nn.functional.pad(t, (0, width - d))


def _flip(bits: torch.Tensor) -> torch.Tensor:
    """IEEE-f32 bits (as int32) -> signed-int total order; an involution."""
    return torch.where(bits < 0, bits ^ _INT_MAX, bits)


def _library():
    lib = _build.load("scan_topk")
    if not getattr(lib, "_gbnns_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gbnns_binned_scan.argtypes = ([p] * 7 + [i] * 7
                                          + [ctypes.c_float, p])
        lib.gbnns_binned_scan.restype = i
        lib.gbnns_merge_topc.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gbnns_merge_topc.restype = i
        lib._gbnns_bound = True
    return lib


def _shifted_library():
    lib = _build.load("shifted_scan")
    if not getattr(lib, "_gbnns_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gbnns_shifted_scan.argtypes = [p, p, p, p] + [i] * 6 + [p]
        lib.gbnns_shifted_scan.restype = i
        lib._gbnns_bound = True
    return lib


def _gated_library():
    lib = _build.load("gated_topm")
    if not getattr(lib, "_gbnns_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gbnns_gated_topm.argtypes = [p, p, p, p, p, p] + [i] * 10 + [p]
        lib.gbnns_gated_topm.restype = i
        lib.gbnns_gated_warp_queries.argtypes = [i]
        lib.gbnns_gated_warp_queries.restype = i
        lib._gbnns_bound = True
    return lib


def _check_scan_args(q, x, addvec, qshift, *, bin_size: int, chunk: int,
                     packed: bool, quant: bool) -> None:
    """The Pallas ``binned_scan``'s checks, with its messages where it has
    them; one more: an int8 corpus without ``quant`` is refused (JAX's cast
    of q to it would truncate, and its scores would miss their scale)."""
    if x.dtype not in _KINDS:
        raise TypeError(f"scan corpus must be bfloat16, float16, int8 or "
                        f"float32, got {x.dtype}")
    if quant and qshift is None:
        raise ValueError("quant=True needs qshift = per-query alpha")
    if quant and (q.dtype != torch.int8 or x.dtype != torch.int8):
        raise ValueError(f"quant=True needs int8 q and x, got {q.dtype} "
                         f"/ {x.dtype} (an astype here would truncate)")
    if not quant and x.dtype == torch.int8:
        raise ValueError("an int8 corpus scans with quant=True and qshift = "
                         "the per-query alpha")
    others = [q, addvec] + ([] if qshift is None else [qshift])
    if any(t.device != x.device for t in others):
        raise ValueError("scan inputs must all lie on one device")
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)}")
    if qshift is not None and tuple(qshift.shape) != (q.shape[0],):
        raise ValueError(f"qshift has shape {tuple(qshift.shape)}, not "
                         f"({q.shape[0]},)")
    n_pad = x.shape[0]
    if bin_size < 1 or chunk < 1 or n_pad % chunk or chunk % bin_size \
            or tuple(addvec.shape) != (n_pad,):
        raise ValueError(f"need n_pad % chunk == chunk % bin_size == 0 with "
                         f"one addvec entry a row: n_pad {n_pad}, chunk "
                         f"{chunk}, bin_size {bin_size}, addvec "
                         f"{tuple(addvec.shape)}")
    if packed and bin_size & (bin_size - 1):
        raise ValueError("packed selection needs power-of-two bin_size")


def dot_scale(metric: str, prescaled: bool, quant: bool) -> float:
    """The factor on a scan's dot product: 1 for a prescaled corpus and for
    int8 (whose alpha carries it), else -2 for l2 and -1 for every other
    metric, as the Pallas kernel reads ``l2=metric == "l2"``."""
    if prescaled or quant:
        return 1.0
    return -2.0 if metric == "l2" else -1.0


def binned_scan_plain(q, x, addvec, qshift=None, *, metric: str = "l2",
                      bin_size: int = 1024, chunk: int = 16384,
                      tq: int = 512, interpret: bool = False,
                      packed: bool = True, prescaled: bool = False,
                      transpose: bool = True, quant: bool = False):
    """Plain PyTorch version of ``binned_scan`` (same contract).

    The dots run as fp32 products with TF32 off: exact products of bf16
    and fp16 inputs, fp32 products of fp32 inputs, and exact integer sums
    for int8 (|dot| <= d * 127² < 2^24 for d < 1040). Then the scale (an
    exact power of two), the shift, the selection and the key, in the
    Pallas kernel's order."""
    _check_scan_args(q, x, addvec, qshift, bin_size=bin_size, chunk=chunk,
                     packed=packed, quant=quant)
    B = q.shape[0]
    n_bins = x.shape[0] // bin_size
    shifted = qshift is not None and not quant
    scale = dot_scale(metric, prescaled, quant)
    vals = torch.empty((n_bins, B), dtype=torch.float32, device=x.device)
    ids = torch.empty((n_bins, B), dtype=torch.int32, device=x.device)
    qf = q.to(x.dtype).float()
    qs = None if qshift is None else qshift.float()[None, :]
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
        if quant:
            s = add + dots * qs
        else:
            s = add + dots if scale == 1.0 else add + scale * dots
            if shifted:
                s = s + qs
        s = s.view(b1 - b0, bin_size, B)
        if packed:
            bits = s.view(torch.int32)
            key = ((bits if shifted else _flip(bits)) & ~mask) \
                | iota[None, :, None]
            kmin = key.amin(dim=1)
            vbits = kmin & ~mask
            vals[b0:b1] = (vbits if shifted else _flip(vbits)).view(
                torch.float32)
            pos = kmin & mask
        else:
            v, pos = s.min(dim=1)                  # first min: lower row
            vals[b0:b1] = v
        base = torch.arange(b0, b1, device=x.device, dtype=torch.int64)
        ids[b0:b1] = (pos + base[:, None] * bin_size).to(torch.int32)
    return (vals.T, ids.T) if transpose else (vals, ids)


def binned_scan(q, x, addvec, qshift=None, *, metric: str = "l2",
                bin_size: int = 1024, chunk: int = 16384, tq: int = 512,
                interpret: bool = False, packed: bool = True,
                prescaled: bool = False, transpose: bool = True,
                quant: bool = False, cores: str | None = None):
    """Bin winners of the full scan: ``(vals (B, n_bins) f32, ids (B,
    n_bins) int32)``, ids being corpus rows; bin-major ``(n_bins, B)`` with
    ``transpose=False`` (unpadded: a Pallas caller's ``[:, :B]`` leaves it
    as it is). The Pallas ``binned_scan``'s contract:

    q (B, d), cast to x's type; x (n_pad, d) bfloat16, float16 or float32,
    stored ``-2x``/``-x`` when ``prescaled`` (the scores are in the module
    docstring); n_pad a multiple of ``chunk`` and ``chunk`` of
    ``bin_size``; addvec (n_pad,) f32. ``qshift`` (B,) is the per-query
    shift of a float scan, or the per-query alpha of an int8 one
    (``quant=True``: q and x int8; required there). ``packed`` selects on
    an int key, the score quantized to 2^(log2 bin_size - 23) relative
    (ties to the lower row). ``chunk`` sets nothing but the check; ``tq``
    and ``interpret`` are accepted and change nothing.

    Any d: the kernels take ``SCAN_WIDTHS`` and larger multiples of 16,
    and on the card any other d is padded with zero columns to
    ``scan_width(d)`` (exact), which copies q and x once a call, (B + n_pad)
    * (scan_width(d) - d) * itemsize bytes of zeros and the data beside
    them (the port's indexes store padded corpora and never pay it). CPU
    tensors take ``binned_scan_plain``; CUDA tensors launch K1 on the cores
    ``scan_cores`` names, or on ``cores`` ("cuda" takes every shape,
    "tensor" only those ``scan_cores`` gives it) to compare the routes.
    In fp16 an unprescaled query must stay below 32,768 in magnitude on
    the card: the d <= 128 tensor-core kernel carries the l2 factor -2 on
    it.
    """
    route = _route(cores, scan_cores(x.dtype, q.shape[1], bin_size),
                   "binned_scan")
    if x.device.type == "cpu":
        return binned_scan_plain(
            q, x, addvec, qshift, metric=metric, bin_size=bin_size,
            chunk=chunk, packed=packed, prescaled=prescaled,
            transpose=transpose, quant=quant)
    _check_scan_args(q, x, addvec, qshift, bin_size=bin_size, chunk=chunk,
                     packed=packed, quant=quant)
    if x.device.type != "cuda":
        raise ValueError(f"binned_scan runs on cuda or cpu, not {x.device}")
    B = q.shape[0]
    d = scan_width(q.shape[1])
    q, x = _pad_columns(q.to(x.dtype), d), _pad_columns(x, d)
    q, x = _build.aligned(q), _build.aligned(x)
    addvec = _build.aligned(addvec.float())
    qs = None if qshift is None else _build.aligned(qshift.float())
    alpha, shift = (qs, None) if quant else (None, qs)
    n_bins = x.shape[0] // bin_size
    vals = torch.empty((n_bins, B), dtype=torch.float32, device=x.device)
    ids = torch.empty((n_bins, B), dtype=torch.int32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gbnns_binned_scan(
            q.data_ptr(), x.data_ptr(), addvec.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            None if shift is None else shift.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), B, x.shape[0], d, bin_size, _KINDS[x.dtype],
            int(packed), int(route == "tensor"),
            dot_scale(metric, prescaled, quant), stream)
    _build.check(lib, err, "binned_scan")
    launches.count("binned_scan")
    launches_by_cores.count(f"binned_scan:{route}")
    return (vals.T, ids.T) if transpose else (vals, ids)


def _bf16_round(v) -> np.ndarray:
    """f32 → nearest bfloat16, ties to even (as ``ml_dtypes`` casts) → f32."""
    t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _split_hi_lo(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32 vector → bf16-representable (hi, lo) with hi+lo ≈ v to ~2^-17."""
    hi = _bf16_round(v)
    lo = _bf16_round(v - hi)
    return hi, lo


def augment_corpus(x_lo_pad: np.ndarray, n: int, metric: str) -> np.ndarray:
    """Fold the full distance into one product: x_aug (n_pad, d+4 for l2,
    d+1 for ip/angular) f32, cast to the scan type by the caller. The JAX
    package's ``augment_corpus``, bit for bit.

      l2:  x_aug = [-2x | nhi | nlo | 1 | 1]  vs  q_aug = [q | 1 | 1 | qhi | qlo]
           → score = ‖x‖² − 2q·x + ‖q‖²  (the squared distance, >= ~0)
      ip:  x_aug = [-x | 1]                vs  q_aug = [q | C_q]
           → score = C_q − q·x >= 0 with C_q = 1.02·‖q‖·max‖x‖ + 1

    The data columns are the bf16-rounded rows (-2x is an exact exponent
    shift) whatever the scan type, and the norms are of those rows, split
    into bf16 (hi, lo) pairs. Padding rows (index >= n) are zero but for
    +inf in column d, so their score is +inf and they never win a bin."""
    n_pad, d = x_lo_pad.shape
    xr = _bf16_round(x_lo_pad)
    if metric == "l2":
        nsq = (xr * xr).sum(-1)
        nhi, nlo = _split_hi_lo(nsq)
        aug = np.zeros((n_pad, d + 4), np.float32)
        aug[:, :d] = -2.0 * xr
        aug[:, d] = nhi
        aug[:, d + 1] = nlo
        aug[:, d + 2] = 1.0
        aug[:, d + 3] = 1.0
        aug[n:, :] = 0.0
        aug[n:, d] = np.inf
        return aug
    aug = np.zeros((n_pad, d + 1), np.float32)
    aug[:, :d] = -xr
    aug[:, d] = 1.0
    aug[n:, :] = 0.0
    aug[n:, d] = np.inf    # C_q >= 1, so a padding score is +inf
    return aug


def augment_queries(q: torch.Tensor, metric: str,
                    max_norm: float) -> torch.Tensor:
    """The queries' side of ``augment_corpus``, on their device: q goes in
    unrounded (the scan casts it to its type); only the norm is of the
    bf16-rounded query, its hi part bf16 and its lo part the f32 rest."""
    q = q.float()
    qb = q.to(torch.bfloat16).float()
    if metric == "l2":
        qsq = (qb * qb).sum(1)
        qhi = qsq.to(torch.bfloat16).float()
        qlo = qsq - qhi
        ones = torch.ones_like(qsq)
        return torch.cat([q, ones[:, None], ones[:, None], qhi[:, None],
                          qlo[:, None]], 1)
    cq = 1.02 * torch.sqrt((qb * qb).sum(1)) * max_norm + 1.0
    return torch.cat([q, cq[:, None]], 1)


# The shifted kernels' element kinds.
_SHIFTED_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def shifted_width(d_aug: int) -> int:
    """The width T3 runs ``d_aug`` augmented columns at on the card: a
    multiple of 4, which every kernel takes, and of 8 past
    ``SHIFTED_TC_MAX_WIDTH``, so that a 16-bit row is a multiple of 16
    bytes (the shared-memory kernel's copies). ``shifted_scan`` pads to it
    with zero columns; ``FusedScanIndex(mode="shifted")`` stores it."""
    w = _round_up(d_aug, 4)
    return _round_up(w, 8) if w > SHIFTED_TC_MAX_WIDTH else w


def _route(cores, default: str, what: str) -> str:
    """``cores`` as asked (None: ``default``, the route function's choice);
    "tensor" only where that function gives it."""
    if cores is None:
        return default
    if cores not in ("tensor", "cuda"):
        raise ValueError(f"cores is 'tensor', 'cuda' or None, not {cores!r}")
    if cores == "tensor" and default != "tensor":
        raise ValueError(f"{what} has no tensor-core kernel for this kind "
                         f"and shape")
    return cores


def _check_shifted_args(q_aug, x_aug, bin_size: int) -> None:
    """The Pallas ``shifted_scan``'s checks, with its messages."""
    if x_aug.dtype == torch.int8:
        raise TypeError("the shifted scan takes a bfloat16, float16 or "
                        "float32 corpus; int8 scans require mode='binned'")
    if x_aug.dtype not in _SHIFTED_DTYPES:
        raise TypeError(f"the shifted scan's corpus must be bfloat16, float16 "
                        f"or float32, got {x_aug.dtype}")
    if q_aug.device != x_aug.device:
        raise ValueError("shifted scan inputs must lie on one device")
    if q_aug.ndim != 2 or x_aug.ndim != 2:
        raise ValueError(f"shape mismatch: q_aug {tuple(q_aug.shape)}, "
                         f"x_aug {tuple(x_aug.shape)}")
    if x_aug.shape[1] != q_aug.shape[1]:
        raise ValueError(f"q_aug width {q_aug.shape[1]} != x_aug width "
                         f"{x_aug.shape[1]} (augment mismatch)")
    if bin_size < 1 or bin_size & (bin_size - 1):
        raise ValueError("shifted selection needs power-of-two bin_size")
    if x_aug.shape[0] % bin_size:
        raise ValueError(f"corpus rows {x_aug.shape[0]} must be a multiple "
                         f"of bin_size {bin_size}")


def shifted_scan_plain(q_aug, x_aug, *, bin_size: int = 1024):
    """Plain PyTorch version of ``shifted_scan`` (same contract): the keys
    of the Pallas ``_scan_kernel_shifted``.

    q is cast to the corpus type; the products run in fp32 with TF32 off
    (exact products of bf16 and fp16 inputs), in score blocks of at most
    2^26 entries. The key is the score's RAW IEEE bits with the in-bin row
    in the low bits: no sign flip, so among negative scores (only exact
    duplicate rows give them) the int order is the raw-bits order, as in
    the Pallas kernel."""
    _check_shifted_args(q_aug, x_aug, bin_size)
    B = q_aug.shape[0]
    n_bins = x_aug.shape[0] // bin_size
    dev = x_aug.device
    vals = torch.empty((n_bins, B), dtype=torch.float32, device=dev)
    ids = torch.empty((n_bins, B), dtype=torch.int32, device=dev)
    qf = q_aug.to(x_aug.dtype).float()
    mask = bin_size - 1
    step = max(1, (1 << 26) // (B * bin_size))
    iota = torch.arange(bin_size, dtype=torch.int32, device=dev)
    for b0 in range(0, n_bins, step):
        b1 = min(n_bins, b0 + step)
        with exact_fp32():
            s = x_aug[b0 * bin_size:b1 * bin_size].float() @ qf.T
        key = ((s.view(torch.int32) & ~mask).view(b1 - b0, bin_size, B)
               | iota[None, :, None])
        kmin = key.amin(dim=1)
        vals[b0:b1] = (kmin & ~mask).view(torch.float32)
        base = torch.arange(b0, b1, device=dev, dtype=torch.int32)
        ids[b0:b1] = (kmin & mask) + base[:, None] * bin_size
    return vals.T, ids.T


def shifted_scan(q_aug, x_aug, *, bin_size: int = 1024,
                 cores: str | None = None):
    """Bin winners of the shifted-key scan, query-major: ``(vals (B,
    n_bins) f32, ids (B, n_bins) int32)``; the values are the scores
    quantized to 2^(log2 bin_size - 23) relative (monotone within a
    query), the ids corpus rows.

    q_aug (B, d_aug) from ``augment_queries`` (cast to the corpus type),
    x_aug (n_pad, d_aug) bfloat16, float16 or float32 from
    ``augment_corpus``, n_pad a multiple of the power-of-two ``bin_size``.
    CPU tensors take ``shifted_scan_plain``; CUDA tensors launch T3 on the
    cores ``shifted_cores`` names, or on ``cores`` as ``binned_scan`` takes
    it, at any d_aug: one off ``shifted_width(d_aug)`` is padded with zero
    columns to it (exact; a copy of both operands a call, as
    ``binned_scan`` pads, which the shifted index, storing that width,
    never pays)."""
    route = _route(cores, shifted_cores(x_aug.dtype, q_aug.shape[1],
                                        bin_size), "shifted_scan")
    if x_aug.device.type == "cpu":
        return shifted_scan_plain(q_aug, x_aug, bin_size=bin_size)
    _check_shifted_args(q_aug, x_aug, bin_size)
    if x_aug.device.type != "cuda":
        raise ValueError(f"shifted_scan runs on cuda or cpu, not "
                         f"{x_aug.device}")
    B = q_aug.shape[0]
    d_aug = shifted_width(q_aug.shape[1])
    q = _pad_columns(q_aug.to(x_aug.dtype), d_aug)
    q, x = _build.aligned(q), _build.aligned(_pad_columns(x_aug, d_aug))
    n_bins = x.shape[0] // bin_size
    vals = torch.empty((n_bins, B), dtype=torch.float32, device=x.device)
    ids = torch.empty((n_bins, B), dtype=torch.int32, device=x.device)
    lib = _shifted_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gbnns_shifted_scan(
            q.data_ptr(), x.data_ptr(), vals.data_ptr(), ids.data_ptr(), B,
            x.shape[0], d_aug, bin_size, _KINDS[x.dtype],
            int(route == "tensor"), stream)
    _build.check(lib, err, "shifted_scan")
    launches.count("shifted_scan")
    launches_by_cores.count(f"shifted_scan:{route}")
    return vals.T, ids.T


# The gated kernel's element kinds, and the most winners it keeps a chunk.
_GATED_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
GATED_MAX_M = 32


def _check_gated_args(q, x, addvec, tile_mask, *, fine: int, m: int,
                      sub: int, chunk: int, tq: int) -> tuple[int, int]:
    """The Pallas ``gated_topm_scan``'s checks; returns (n_chunks, b_tiles).
    One more: chunk / fine must be a power of two, since the Pallas kernel
    reads a fine bin back from the key's low bits with that mask."""
    if x.dtype == torch.int8:
        raise TypeError("the gated scan takes a bfloat16, float16 or float32 "
                        "corpus (prescaled -2x or -x), not int8")
    if x.dtype not in _GATED_DTYPES:
        raise TypeError(f"the gated scan's corpus must be bfloat16, float16 "
                        f"or float32, got {x.dtype}")
    if any(t.device != x.device for t in (q, addvec, tile_mask)):
        raise ValueError("gated scan inputs must all lie on one device")
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)}")
    B, n_pad = q.shape[0], x.shape[0]
    for v, name in ((fine, "fine"), (sub, "sub"), (m, "m")):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name} must be a power of two, got {v}")
    if n_pad % chunk or chunk % sub or sub % fine:
        raise ValueError(f"need n_pad % chunk == chunk % sub == sub % fine "
                         f"== 0: n_pad {n_pad}, chunk {chunk}, sub {sub}, "
                         f"fine {fine}")
    nfb = chunk // fine
    if nfb & (nfb - 1):
        raise ValueError(f"chunk / fine must be a power of two, got {nfb}")
    if B % tq:
        raise ValueError(f"the gated scan needs the caller to pad B ({B}) "
                         f"to a multiple of tq ({tq})")
    if m > nfb:
        raise ValueError(f"m={m} > fine bins per chunk {nfb}")
    n_chunks, b_tiles = n_pad // chunk, B // tq
    if tuple(tile_mask.shape) != (n_chunks * b_tiles,):
        raise ValueError(f"tile_mask has shape {tuple(tile_mask.shape)}, not "
                         f"({n_chunks * b_tiles},)")
    if tuple(addvec.shape) != (n_pad,):
        raise ValueError("addvec must have one entry per corpus row")
    return n_chunks, b_tiles


def gated_topm_scan_plain(q, x, addvec, tile_mask, *, metric: str = "l2",
                          fine: int = 128, m: int = 16, sub: int = 1024,
                          chunk: int = 16384, tq: int = 1024):
    """Plain PyTorch version of ``gated_topm_scan`` (same contract): the
    keys of the Pallas ``_gated_topm_kernel``, computed per kept cell.

    Queries are cast to the corpus type, as the Pallas wrapper does, and
    the dots run as fp32 products with TF32 off (exact products of bf16
    and fp16 inputs), in score blocks of at most 2^26 entries. The keys
    are unique within a query, so the m extraction rounds are the m
    smallest keys in ascending order (``torch.topk``). ``metric`` is not
    read: the corpus comes prescaled."""
    n_chunks, b_tiles = _check_gated_args(q, x, addvec, tile_mask, fine=fine,
                                          m=m, sub=sub, chunk=chunk, tq=tq)
    B = q.shape[0]
    dev = x.device
    vals = torch.full((n_chunks * m, B), float("inf"), dtype=torch.float32,
                      device=dev)
    ids = torch.full((n_chunks * m, B), -1, dtype=torch.int32, device=dev)
    qf = q.to(x.dtype).float()
    nfb = chunk // fine
    km = max(sub, nfb) - 1
    sub_mask = sub - 1
    in_block = (torch.arange(chunk, dtype=torch.int32, device=dev)
                & sub_mask)[:, None]
    bins = torch.arange(nfb, dtype=torch.int32, device=dev)[:, None]
    lane = torch.arange(tq, device=dev)
    keep = (tile_mask.view(n_chunks, b_tiles) > 0).cpu()
    step = max(1, (1 << 26) // (chunk * tq))     # query tiles per block
    for j in range(n_chunks):
        kept = torch.nonzero(keep[j]).flatten().to(dev)
        if not kept.numel():
            continue
        r0, r1 = j * chunk, (j + 1) * chunk
        xj = x[r0:r1].float()
        add = addvec[r0:r1, None].float()
        for g in range(0, kept.numel(), step):
            cols = (kept[g:g + step, None] * tq + lane).flatten()
            with exact_fp32():
                s = add + xj @ qf[cols].T                     # (chunk, nc)
            pkey = (_flip(s.view(torch.int32)) & ~sub_mask) | in_block
            kmin = pkey.view(nfb, fine, -1).amin(dim=1)       # (nfb, nc)
            key = (kmin & ~km) | bins
            top = torch.topk(key, m, dim=0, largest=False, sorted=True)[0]
            win = top & (nfb - 1)
            row = torch.gather(kmin, 0, win.long()) & sub_mask
            vals[j * m:(j + 1) * m, cols] = _flip(top & ~km).view(
                torch.float32)
            ids[j * m:(j + 1) * m, cols] = (((win * fine) & ~sub_mask) + row
                                            + r0)
    return vals.T, ids.T


def gated_topm_scan(q, x, addvec, tile_mask, *, metric: str = "l2",
                    fine: int = 128, m: int = 16, sub: int = 1024,
                    chunk: int = 16384, tq: int = 1024,
                    cores: str | None = None):
    """Cluster-gated per-chunk top-m candidates: ``(vals (B, m*n_chunks)
    f32, ids (B, m*n_chunks) int32)``, column ``j*m + t`` holding chunk j's
    t-th winner (a corpus position), ascending by the key; a skipped cell
    gives +inf and -1.

    q (B, d) with B a multiple of ``tq`` (the caller pads; the mask layout
    must match), cast to the corpus type; x (n_pad, d) bfloat16, float16 or
    float32, PRESCALED (-2x for l2, -x for ip), cluster-major and
    fine-interleaved (see ``search/gated.py``); addvec (n_pad,) as in
    ``binned_scan``; tile_mask (n_chunks * B/tq,) int32, entry
    ``j * b_tiles + i`` gating corpus chunk j against query tile i. Values
    come back quantized to 2^(log2 max(sub, chunk/fine) - 23) relative.
    CPU tensors take ``gated_topm_scan_plain``; CUDA tensors launch T4
    (m <= ``GATED_MAX_M``) on the cores ``gated_cores`` names, or on
    ``cores`` as ``binned_scan`` takes it, at any d: one off
    ``SCAN_WIDTHS`` and past 128 not a multiple of 16 is padded with zero
    columns to ``scan_width(d)`` (exact; a copy of q and x a call, which
    ``GatedScanIndex``, storing a padded corpus, never pays)."""
    d = scan_width(q.shape[1])   # the width the kernel receives
    route = _route(cores, gated_cores(x.dtype, d, fine=fine, tq=tq),
                   "gated_topm_scan")
    if x.device.type == "cpu":
        return gated_topm_scan_plain(q, x, addvec, tile_mask, metric=metric,
                                     fine=fine, m=m, sub=sub, chunk=chunk,
                                     tq=tq)
    n_chunks, b_tiles = _check_gated_args(q, x, addvec, tile_mask, fine=fine,
                                          m=m, sub=sub, chunk=chunk, tq=tq)
    if x.device.type != "cuda":
        raise ValueError(f"gated_topm_scan runs on cuda or cpu, not "
                         f"{x.device}")
    B = q.shape[0]
    if m > GATED_MAX_M:
        raise ValueError(f"the gated kernel keeps at most {GATED_MAX_M} "
                         f"winners a chunk, got m={m}")
    if n_chunks > 65535:
        raise ValueError(f"the gated kernel takes at most 65,535 chunks, "
                         f"got {n_chunks}")
    q, x = _pad_columns(q.to(x.dtype), d), _pad_columns(x, d)
    q, x = _build.aligned(q), _build.aligned(x)
    addvec = _build.aligned(addvec.float())
    tile_mask = _build.aligned(tile_mask.to(torch.int32))
    vals = torch.empty((n_chunks * m, B), dtype=torch.float32,
                       device=x.device)
    ids = torch.empty((n_chunks * m, B), dtype=torch.int32, device=x.device)
    lib = _gated_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gbnns_gated_topm(
            q.data_ptr(), x.data_ptr(), addvec.data_ptr(),
            tile_mask.data_ptr(), vals.data_ptr(), ids.data_ptr(), B,
            x.shape[0], d, chunk, tq, fine, sub, m, _KINDS[x.dtype],
            int(route == "tensor"), stream)
    _build.check(lib, err, "gated_topm")
    launches.count("gated_topm")
    launches_by_cores.count(f"gated_topm:{route}")
    return vals.T, ids.T


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


def _valid_columns(vals, ids, valid_b: int | None):
    """The first ``valid_b`` query columns (all for None), as the Pallas
    merge keeps them."""
    if valid_b is None or valid_b == vals.shape[1]:
        return vals, ids
    if not 0 <= valid_b <= vals.shape[1]:
        raise ValueError(f"valid_b {valid_b} is not in [0, {vals.shape[1]}]")
    return vals[:, :valid_b], ids[:, :valid_b]


def merge_topc_plain(vals, ids, c: int, *, valid_b: int | None = None,
                     rb: int = 512):
    """Plain PyTorch version of ``merge_topc`` (same contract and stages)."""
    vals, ids = _valid_columns(vals, ids, valid_b)
    ck, rb, fallback = _merge_plan(c, rb, vals.shape[0])
    if fallback:
        return exact_topc(vals, ids, c)
    while True:
        vals, ids = _merge_stage_plain(vals, ids, ck, rb)
        if vals.shape[0] == ck:
            return vals[:c].T, ids[:c].T


def merge_topc(vals, ids, c: int, *, valid_b: int | None = None,
               rb: int = 512, tq: int = 512, interpret: bool = False):
    """Top-c merge of bin-major winners ``vals/ids (R, Bp)`` (from
    ``binned_scan(..., transpose=False)``) → ``(vals (B, c) f32, ids (B, c)
    int32)``, ascending by the quantized key, for the first ``valid_b``
    query columns (None: all of them). The Pallas ``merge_topc``'s
    contract; ``tq`` and ``interpret`` are accepted and change nothing.

    The result of the Pallas version's hierarchical merge: each stage
    reduces blocks of ``rb`` rows to their top ck = round_up(c, 8) by
    flipped-IEEE keys with the in-block row in the low log2(rb) bits, until
    one block remains. That is the top c of all rows in (quantized key,
    row) order, which the kernel computes in one launch. Values come back
    quantized to 2^-(23 - log2 rb) relative; padding slots carry +inf and
    id -1. Past rb = 2048, or when c >= R, the merge is an exact sort
    instead. CPU tensors take ``merge_topc_plain``; CUDA tensors launch K2
    once.
    """
    if vals.device.type == "cpu":
        return merge_topc_plain(vals, ids, c, valid_b=valid_b, rb=rb)
    vals, ids = _valid_columns(vals, ids, valid_b)
    if vals.device.type != "cuda":
        raise ValueError(f"merge_topc runs on cuda or cpu, not {vals.device}")
    if vals.dtype != torch.float32 or ids.dtype != torch.int32 \
            or vals.shape != ids.shape or vals.ndim != 2:
        raise ValueError("merge_topc takes f32 vals and int32 ids of one "
                         "(R, B) shape")
    R, B = vals.shape
    ck, rb, fallback = _merge_plan(c, rb, R)
    if fallback:
        return exact_topc(vals, ids, c)
    lib = _library()
    vals, ids = vals.contiguous(), ids.contiguous()
    out_v = torch.empty((ck, B), dtype=torch.float32, device=vals.device)
    out_i = torch.empty((ck, B), dtype=torch.int32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.gbnns_merge_topc(vals.data_ptr(), ids.data_ptr(),
                                   out_v.data_ptr(), out_i.data_ptr(), R, B,
                                   rb, ck, stream)
    _build.check(lib, err, "merge_topc")
    launches.count("merge_topc")
    return out_v[:c].T, out_i[:c].T


class FusedScanIndex:
    """Flat index whose candidate scan is the fused binned scan.

    Same contract as ``search.flat.FlatIndex`` (reduced-space scan, then an
    exact full-dimension re-rank), but the scan never writes scores to
    device memory. ``c`` (the re-rank pool) is the recall knob.

    ``chunk`` only rounds the corpus up (n_pad = round_up(n, chunk)); it sets
    the count of padding bins, as in the Pallas version. ``tq`` is the
    Pallas version's query tile: the port's kernels tile queries their own
    way, so it is stored and changes no result. ``mode="shifted"`` scans
    the augmented operands of ``augment_corpus`` with ``shifted_scan`` (T3)
    and takes an exact top-c of its winners (the Pallas merge never serves
    that mode); it refuses int8, as the JAX index does.
    """

    def __init__(self, base_full, base_lo=None, *, metric: str = "l2",
                 scan_dtype="bfloat16", bin_size: int = 1024,
                 chunk: int = 16384, tq: int = 1024, packed: bool = False,
                 mode: str = "binned", rerank_dtype=torch.float32,
                 device=None):
        if metric not in ("l2", "ip", "angular"):
            raise ValueError(f"unknown metric {metric!r}")
        if mode not in ("shifted", "binned"):
            raise ValueError(f"unknown mode {mode!r}")
        dtypes = {"bfloat16": torch.bfloat16, "int8": torch.int8,
                  "float32": torch.float32, "float16": torch.float16}
        self.scan_dtype = dtypes.get(scan_dtype, scan_dtype)
        if self.scan_dtype not in dtypes.values():
            raise ValueError(f"scan_dtype must be bfloat16, float16, int8 or "
                             f"float32, got {scan_dtype!r}")
        self.quant = self.scan_dtype == torch.int8
        if self.quant and mode == "shifted":
            raise ValueError("int8 scan requires mode='binned'")
        self.mode = mode
        self.tq = tq
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
        self.d_lo = d_lo
        if mode == "shifted":
            # zero columns up to the kernel's width add nothing to a dot
            # product or a norm
            aug = augment_corpus(lo_pad, n, metric)
            w_aug = shifted_width(width + 4)
            aug = np.pad(aug, ((0, 0), (0, w_aug - aug.shape[1])))
            self.x_aug = (torch.from_numpy(aug).to(self.scan_dtype)
                          .to(self.device))
            self.max_norm = float(np.sqrt((lo ** 2).sum(-1).max()))
        else:
            self._binned_corpus(lo, lo_pad, n)
        # bf16 re-rank halves the candidate gather; the norms stay f32 and
        # are taken before the cast
        bf = torch.from_numpy(base_full).to(self.device)
        self.base_sq = (bf * bf).sum(-1)
        self.base_full = bf.to(rerank_dtype)

    def _binned_corpus(self, lo, lo_pad, n: int) -> None:
        """The binned scan's corpus (prescaled or int8) and addvec."""
        metric, n_pad = self.metric, lo_pad.shape[0]
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
            # prescaled storage: -2x / -x is exact in bf16, fp16 and f32
            self.x_lo = (torch.from_numpy(self.dot_scale * lo_pad)
                         .to(self.scan_dtype).to(self.device))
        self.addvec = torch.from_numpy(add.astype(np.float32)).to(self.device)

    def shifted_queries(self, ql: torch.Tensor) -> torch.Tensor:
        """Augmented f32 queries of the shifted mode, at the corpus's
        width (the scan casts them to its type)."""
        if ql.shape[1] != self.d_lo:
            raise ValueError(f"queries have {ql.shape[1]} reduced dims, the "
                             f"index {self.d_lo}")
        ql = torch.nn.functional.pad(ql, (0, scan_width(self.d_lo)
                                          - self.d_lo))
        q_aug = augment_queries(ql, self.metric, self.max_norm)
        return torch.nn.functional.pad(
            q_aug, (0, self.x_aug.shape[1] - q_aug.shape[1]))

    def scan_kw(self) -> dict:
        """``binned_scan``'s keywords for this index (the Pallas index's):
        its metric and geometry, and a prescaled or an int8 corpus (whose
        ``qshift`` is the per-query alpha of ``scan_queries``)."""
        kind = dict(quant=True) if self.quant else dict(prescaled=True)
        return dict(metric=self.metric, bin_size=self.bin_size,
                    chunk=self.chunk, tq=self.tq, packed=self.packed, **kind)

    def scan_queries(self, ql: torch.Tensor):
        """Queries in the scan's type and width, and the int8 dequant
        factor per query (None for the float kinds)."""
        width = self.x_lo.shape[1]
        if ql.shape[1] != self.d_lo:
            raise ValueError(f"queries have {ql.shape[1]} reduced dims, the "
                             f"index {self.d_lo}")
        if width != self.d_lo:
            ql = torch.nn.functional.pad(ql, (0, width - self.d_lo))
        if not self.quant:
            return ql.to(self.scan_dtype), None
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
        "pallas" on the card and "exact" on the CPU. The shifted mode
        always takes the exact top-c, ties to the lower bin, as the JAX
        index does."""
        if merge is None:
            merge = "pallas" if self.device.type == "cuda" else "exact"
        if merge not in ("pallas", "exact", "approx"):
            raise ValueError(f"unknown merge {merge!r}")
        ql = torch.as_tensor(queries_lo, dtype=torch.float32,
                             device=self.device)
        if self.mode == "shifted":
            vals, ids = shifted_scan(self.shifted_queries(ql), self.x_aug,
                                     bin_size=self.bin_size)
            return exact_topc(vals.T, ids.T, c)[1]
        q_scan, alpha = self.scan_queries(ql)
        vals, ids = binned_scan(q_scan, self.x_lo, self.addvec, alpha,
                                **self.scan_kw(), transpose=False)
        cc = min(c, vals.shape[0])
        if merge == "pallas":
            return merge_topc(vals, ids, cc, valid_b=ql.shape[0])[1]
        return exact_topc(vals, ids, cc)[1]

    def search(self, queries_full, queries_lo=None, *, k: int = 10,
               c: int = 32, merge: str | None = None):
        """Top-k ``(ids (B, k) int32, dists (B, k) f32)`` after the exact
        full-dimension re-rank of the ``c`` scan candidates."""
        qf = torch.as_tensor(queries_full, dtype=torch.float32,
                             device=self.device)
        ql = qf if queries_lo is None else queries_lo
        cand = self.candidates(ql, c=c, merge=merge)
        with torch.profiler.record_function("fused.rerank"):
            return rerank(qf, self.base_full, cand, k, metric=self.metric,
                          base_sqnorms=self.base_sq)


def scan_agreement(got, ref, q, x, addvec, qshift=None, *,
                   metric: str = "l2", bin_size: int = 1024,
                   chunk: int = 16384, tq: int = 512, interpret: bool = False,
                   packed: bool = True, prescaled: bool = False,
                   transpose: bool = True, quant: bool = False,
                   rtol: float = 1e-5) -> dict:
    """Hold a scan's bin winners ``got = (vals, ids)`` against the plain
    version's ``ref`` on the same inputs and ``binned_scan`` keywords (of
    which ``chunk``, ``tq`` and ``interpret`` change no score).

    Values must agree within ``rtol`` (relative to the largest |ref| value,
    since a score near 0 is the difference of larger terms); in packed mode
    within one quantum of the key as well. Ids must be equal, except at a
    near-tie: the plain score at the kernel's row lies within the same
    tolerance of the bin's min. Returns the counts and the largest error;
    ``ok`` says whether every bin passed."""
    if transpose:
        got, ref = (got[0].T, got[1].T), (ref[0].T, ref[1].T)
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
        dots = (x[rows].float() * q[j].to(x.dtype).float()).sum(-1)
        add = addvec[rows].float()
        if quant:
            s = add + dots * qshift[j].float()
        else:
            s = add + dot_scale(metric, prescaled, quant) * dots
            if qshift is not None:
                s = s + qshift[j].float()
        near_ties = int(((s - rv[b, j]).abs() <= tol).sum())
    id_bad = int(miss.shape[0]) - near_ties
    return {"max_abs_err": max_err, "bad_values": bad_vals,
            "id_mismatches": int(miss.shape[0]), "near_ties": near_ties,
            "ok": bad_vals == 0 and id_bad == 0}


def shifted_agreement(got, ref, q_aug, x_aug, *, bin_size: int,
                      rtol: float = 1e-5) -> dict:
    """``scan_agreement`` for the shifted scan's query-major winners: the
    score is the whole dot product of the augmented operands (no addvec),
    keyed as a packed score of ``bin_size``."""
    zero = torch.zeros(x_aug.shape[0], device=x_aug.device)
    return scan_agreement(got, ref, q_aug.to(x_aug.dtype), x_aug, zero,
                          bin_size=bin_size, chunk=x_aug.shape[0],
                          packed=True, prescaled=True, rtol=rtol)


def gated_agreement(got, ref, q, x, addvec, *, fine: int, sub: int,
                    chunk: int, rtol: float = 1e-5) -> dict:
    """Hold a gated scan's winners ``got = (vals, ids)`` (B, m*n_chunks)
    against the plain version's ``ref`` on the same inputs.

    Skipped cells (+inf, -1) must match exactly. Values must agree within
    ``rtol`` of the largest finite |ref| plus one key quantum,
    2^(log2 max(sub, chunk/fine) - 23) of it. Ids must be equal, except at
    a near-tie: the plain score of the kernel's row lies within that
    tolerance of the reference value. Returns the counts and the largest
    error; ``ok`` says whether every winner passed."""
    gv, gi = got[0].float(), got[1].long()
    rv, ri = ref[0].float(), ref[1].long()
    finite = rv[torch.isfinite(rv)]
    scale = max(finite.abs().max().item() if finite.numel() else 1.0, 1e-30)
    bits = int(np.log2(max(sub, chunk // fine)))
    tol = (rtol + 2.0 ** (bits - 23)) * scale
    both_inf = torch.isinf(gv) & torch.isinf(rv) & (gv == rv)
    err = torch.where(both_inf, torch.zeros_like(gv), (gv - rv).abs())
    max_err = err.max().item() if err.numel() else 0.0
    bad_vals = int((err > tol).sum())
    skipped = (ri < 0) | (gi < 0)
    bad_skips = int((skipped & (gi != ri)).sum())
    miss = ((gi != ri) & ~skipped).nonzero()
    near_ties = 0
    if miss.numel():
        b, c = miss[:, 0], miss[:, 1]
        rows = gi[b, c]
        qf = q.to(x.dtype).float()
        s = addvec[rows].float() + (x[rows].float() * qf[b]).sum(-1)
        near_ties = int(((s - rv[b, c]).abs() <= tol).sum())
    id_bad = int(miss.shape[0]) - near_ties
    return {"max_abs_err": max_err, "bad_values": bad_vals,
            "bad_skips": bad_skips, "id_mismatches": int(miss.shape[0]),
            "near_ties": near_ties,
            "ok": bad_vals == 0 and bad_skips == 0 and id_bad == 0}
