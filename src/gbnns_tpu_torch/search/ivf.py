"""IVF cluster-pruned scan: a k-means coarse quantizer over the reduced
space, the corpus laid out in fixed-capacity cluster blocks, and a
cluster-major search.

Port of ``gbnns_tpu/search/ivf.py``. The build is numpy on the host over
``build/kmeans.py``; every row past a cluster's capacity goes to a small
spill block that every query scans. A search ranks the centroids per query,
buckets the (query, probe) pairs by cluster with a stable sort (never a
scatter), scores each cluster's bucket against its block in one batched
product, routes the per-cluster survivors back to their queries by
inverting the same sort, merges them with the spill scan and re-ranks the
pool at full dimension (``search/rerank.py``).

Differences from the JAX module, none of which changes a result on the CPU:
  * the centroid ranking and both candidate selections are exact, ties to
    the lower column, as ``lax.top_k`` (the TPU's ``approx_max_k`` equals it
    on the CPU); they use the (value, column) keys of
    ``kernels.topk._smallest_by_key`` so no selection waits for the host;
  * the centroid distances are full fp32 (TF32 off), which is what JAX's
    ``precision="default"`` gives on the CPU;
  * the per-cluster and spill products take bf16 or fp16 operands with fp32
    results (JAX's ``preferred_element_type``): on the card through
    ``torch.bmm(..., out_dtype=torch.float32)``, on the CPU by upcasting to
    fp32, where the products of bf16 values are exact.

A search never synchronizes with the host: its shapes follow from
(B, probes, qslots), so a pipelined timing of it means what it says. Its
stages are named ranges (``ivf.probe``, ``ivf.bucket``, ``ivf.scan``,
``ivf.route``, ``ivf.merge``, ``ivf.rerank``) in a profiler trace.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import (METRICS, exact_fp32,
                                              pairwise_dists)
from gbnns_tpu_torch.kernels.topk import _smallest_by_key
from gbnns_tpu_torch.search.rerank import rerank

_INF = float("inf")
_SCAN_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32}


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (G, M, d) @ b (G, N, d)^T`` with fp32 results: (G, M, N)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b.transpose(1, 2), out_dtype=torch.float32)
    with exact_fp32():
        return torch.bmm(a.float(), b.float().transpose(1, 2))


def ivf_search(q_lo, q_full, centroids, cent_sq, block_ids, blocks_lo,
               block_sq, spill_ids, spill_lo, spill_sq, base_full, base_sq,
               *, k: int, c: int, probes: int, cprobe: int, qslots: int,
               metric: str):
    """Cluster-major pruned scan. Returns (ids (B, k) int32, dists (B, k)
    f32).

    ``probes``: clusters scanned per query; ``cprobe``: candidates kept per
    (query, cluster) pair; ``c``: merged re-rank pool; ``qslots``: query
    slots per cluster (bucket capacity). Scan-space distances drop the
    ||q||^2 term (constant per query); the re-rank recomputes exact
    full-dimension distances.
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    dev = q_lo.device
    B, d_lo = q_lo.shape
    ncent, cap = block_ids.shape
    S = spill_ids.shape[0]
    p = min(probes, ncent)
    cp = min(cprobe, cap)
    Qc = qslots
    scan_dtype = blocks_lo.dtype
    qf32 = q_lo.float()

    # ---- stage A: each query's probe clusters, nearest first -------------
    with record_function("ivf.probe"):
        cd = pairwise_dists(qf32, centroids, metric=metric, x_sqnorms=cent_sq)
        _, probe_cl = _smallest_by_key(cd, p)                   # (B, p)
        del cd
        cl = probe_cl.reshape(B * p)
        qi = torch.arange(B, device=dev).repeat_interleave(p)
        rank = torch.arange(p, device=dev).repeat(B)

    # ---- bucket the pairs by cluster (a stable sort, never a scatter) ----
    with record_function("ivf.bucket"):
        # (cluster, rank) order: under bucket overflow the highest-rank
        # probes are dropped first
        perm = torch.argsort(cl * p + rank, stable=True)
        cl_s = cl[perm]
        qi_s = qi[perm]
        start = torch.searchsorted(cl_s, torch.arange(ncent, device=dev))
        slot = torch.arange(B * p, device=dev) - start[cl_s]
        keep = slot < Qc
        grid = ncent * Qc
        g = torch.where(keep, cl_s * Qc + slot, grid)           # sentinel
        # occupancy table (ncent, Qc) by sorted membership: overflow slots
        # are clamped to their cluster's last slot id, which keeps the
        # sequence sorted, so the left-sided search's first hit is the true
        # occupant
        g_occ = torch.where(keep, g, cl_s * Qc + (Qc - 1))
        o = torch.arange(grid, device=dev)
        j = torch.searchsorted(g_occ, o).clamp_(max=B * p - 1)
        hit = g_occ[j] == o
        q_of_slot = torch.where(hit, qi_s[j], 0)  # unfilled slots: never read

    # ---- stage B: each cluster's bucket against its block ----------------
    with record_function("ivf.scan"):
        qvecs = qf32[q_of_slot].reshape(ncent, Qc, d_lo).to(scan_dtype)
        dots = _dots(qvecs, blocks_lo)                          # (ncent,Qc,cap)
        del qvecs
        if metric == "l2":
            dist = block_sq[:, None, :] - 2.0 * dots
        else:
            dist = -dots
        del dots
        dist = torch.where(block_ids[:, None, :] < 0, _INF, dist)
        nd, pos = _smallest_by_key(dist.reshape(grid, cap), cp)
        del dist
        slot_ids = torch.gather(block_ids, 1, pos.reshape(ncent, Qc * cp))
        # one padding row for the dropped pairs (g == grid)
        flat_d = torch.cat([nd, torch.full((1, cp), _INF, device=dev)])
        flat_i = torch.cat([slot_ids.reshape(grid, cp),
                            torch.full((1, cp), -1, dtype=slot_ids.dtype,
                                       device=dev)])

    # ---- route the candidates back to their queries ----------------------
    with record_function("ivf.route"):
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(B * p, device=dev)
        g_r = g[inv]
        pair_d = flat_d[g_r].reshape(B, p * cp)
        pair_i = flat_i[g_r].reshape(B, p * cp)

    # ---- the spill rows, scanned by every query; the merged pool ---------
    with record_function("ivf.merge"):
        sdots = _dots(qf32.to(scan_dtype)[None], spill_lo[None])[0]  # (B, S)
        sdist = (spill_sq[None, :] - 2.0 * sdots) if metric == "l2" \
            else -sdots
        sdist = torch.where(spill_ids[None, :] < 0, _INF, sdist)
        all_d = torch.cat([pair_d, sdist], dim=1)
        all_i = torch.cat([pair_i, spill_ids[None, :].expand(B, S)], dim=1)
        cc = min(c, all_d.shape[1])
        _, sel = _smallest_by_key(all_d, cc)
        cand = torch.gather(all_i, 1, sel)                      # (B, cc)

    # ---- exact full-dimension re-rank ------------------------------------
    with record_function("ivf.rerank"):
        return rerank(q_full, base_full, cand, k, metric=metric,
                      base_sqnorms=base_sq)


@dataclasses.dataclass
class IVFIndex:
    """Device-resident cluster-blocked index over a (reduced) search space."""

    centroids: torch.Tensor   # (ncent, d_lo) f32
    cent_sq: torch.Tensor     # (ncent,) f32
    block_ids: torch.Tensor   # (ncent, cap) int32, -1 padding
    blocks_lo: torch.Tensor   # (ncent, cap, d_lo) scan dtype
    block_sq: torch.Tensor    # (ncent, cap) f32
    spill_ids: torch.Tensor   # (S,) int32, -1 padding
    spill_lo: torch.Tensor    # (S, d_lo) scan dtype
    spill_sq: torch.Tensor    # (S,) f32
    base_full: torch.Tensor   # (n, d) f32 (re-rank corpus)
    base_sq: torch.Tensor     # (n,) f32
    metric: str
    stats: dict

    @classmethod
    def build(cls, base_full, base_lo=None, *, ncent: int | None = None,
              cap: int | None = None, metric: str = "l2", iters: int = 10,
              seed: int = 0, sample: int | None = 262_144,
              scan_dtype=torch.bfloat16, assignments: np.ndarray | None = None,
              centroids: np.ndarray | None = None,
              device=None) -> "IVFIndex":
        """Fit the quantizer and lay the corpus out in cluster blocks.

        ``ncent`` defaults to ~4*sqrt(n) rounded to a power of two, ``cap``
        to twice the mean cluster size rounded up to 8; rows past ``cap``
        in an oversized cluster go to the spill block. ``scan_dtype``:
        bfloat16, float16 or float32 (a torch dtype or its name).
        """
        from gbnns_tpu_torch.build.kmeans import kmeans_assign, kmeans_fit

        dev = resolve_device(device)
        scan_dtype = _SCAN_DTYPES.get(scan_dtype, scan_dtype)
        if scan_dtype not in _SCAN_DTYPES.values():
            raise ValueError(f"scan_dtype must be bfloat16, float16 or "
                             f"float32, got {scan_dtype!r}")
        base_full = np.asarray(base_full, np.float32)
        lo = base_full if base_lo is None else np.asarray(base_lo, np.float32)
        n, d_lo = lo.shape
        if ncent is None:
            ncent = int(2 ** round(np.log2(max(8.0, 4.0 * np.sqrt(n)))))
            ncent = max(8, min(ncent, n // 4))
        if centroids is None:
            centroids = kmeans_fit(lo, ncent, iters=iters, seed=seed,
                                   sample=sample, device=dev)
        else:
            centroids = np.asarray(centroids, np.float32)
            ncent = centroids.shape[0]
        assign = (kmeans_assign(lo, centroids, device=dev)
                  if assignments is None else np.asarray(assignments))

        counts = np.bincount(assign, minlength=ncent)
        if cap is None:
            cap = _round_up(max(8, int(2.0 * max(1.0, counts.mean()))), 8)

        # stable sort of the rows by cluster; rank within a cluster by offset
        idx = np.argsort(assign, kind="stable").astype(np.int64)
        a_sorted = assign[idx]
        starts = np.zeros(ncent, np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        pos = np.arange(n, dtype=np.int64) - starts[a_sorted]
        in_block = pos < cap

        block_ids = np.full((ncent, cap), -1, np.int32)
        blocks_lo = np.zeros((ncent, cap, d_lo), np.float32)
        rows = idx[in_block]
        block_ids[a_sorted[in_block], pos[in_block]] = rows.astype(np.int32)
        blocks_lo[a_sorted[in_block], pos[in_block]] = lo[rows]
        block_sq = (blocks_lo ** 2).sum(-1)

        spill_rows = idx[~in_block]
        S = max(128, _round_up(len(spill_rows), 128))
        spill_ids = np.full(S, -1, np.int32)
        spill_lo = np.zeros((S, d_lo), np.float32)
        spill_ids[:len(spill_rows)] = spill_rows.astype(np.int32)
        spill_lo[:len(spill_rows)] = lo[spill_rows]
        spill_sq = (spill_lo ** 2).sum(-1)

        stats = dict(n=n, ncent=int(ncent), cap=int(cap),
                     spill=int(len(spill_rows)),
                     spill_frac=float(len(spill_rows)) / n,
                     mean_cluster=float(counts.mean()),
                     max_cluster=int(counts.max()))

        def put(a, dtype=None):
            t = torch.from_numpy(np.require(a, requirements="CW")).to(dev)
            return t if dtype is None else t.to(dtype)

        bf = put(base_full)
        return cls(
            centroids=put(centroids),
            cent_sq=put((centroids.astype(np.float32) ** 2).sum(-1)),
            block_ids=put(block_ids),
            blocks_lo=put(blocks_lo, scan_dtype),
            block_sq=put(block_sq),
            spill_ids=put(spill_ids),
            spill_lo=put(spill_lo, scan_dtype),
            spill_sq=put(spill_sq),
            base_full=bf,
            base_sq=(bf * bf).sum(-1),
            metric=metric, stats=stats)

    def qslots_for(self, n_queries: int, probes: int, slack: float = 2.0) -> int:
        """Bucket capacity: ``slack``x the mean per-cluster pair load."""
        ncent = self.block_ids.shape[0]
        mean = max(1.0, n_queries * min(probes, ncent) / ncent)
        return _round_up(int(np.ceil(slack * mean)), 8)

    def search(self, queries_full, queries_lo=None, *, k: int = 10,
               c: int = 32, probes: int = 16, cprobe: int | None = None,
               slack: float = 2.0):
        """Pruned-scan search: ``probes`` clusters a query (the recall
        knob), a re-rank pool of ``c``, bucket headroom ``slack``."""
        dev = self.base_full.device
        qf = torch.as_tensor(queries_full, dtype=torch.float32, device=dev)
        ql = qf if queries_lo is None else torch.as_tensor(
            queries_lo, dtype=torch.float32, device=dev)
        if cprobe is None:
            cprobe = max(k, min(32, c))
        return ivf_search(ql, qf, self.centroids, self.cent_sq,
                          self.block_ids, self.blocks_lo, self.block_sq,
                          self.spill_ids, self.spill_lo, self.spill_sq,
                          self.base_full, self.base_sq,
                          k=k, c=c, probes=probes, cprobe=cprobe,
                          qslots=self.qslots_for(ql.shape[0], probes, slack),
                          metric=self.metric)
