"""Cluster-gated fused scan: a scan that skips whole (corpus chunk x query
tile) cells that no query of the tile needs.

Port of ``gbnns_tpu/search/gated.py``.

  offline   k-means the corpus into clusters of ~chunk/4 rows, pack whole
            clusters into corpus chunks along a nearest-neighbour chain of
            the centroids (oversize clusters split at chunk boundaries), and
            interleave each chunk's rows across its fine bins; rank each
            cluster's neighbour clusters by centroid distance (the routing
            table);
  at query  (1) each query's PRIMARY cluster, the nearest centroid; (2) the
            query inherits its primary's ``probes`` nearest clusters, so
            sorting the batch by the primary's chain rank makes the tiles'
            kept-chunk unions tight; (3) the gated scan (T4,
            ``kernels.scan_topk.gated_topm_scan``) gives each query the m
            best fine-bin winners of each kept chunk, a skipped cell +inf;
            (4) an exact selection of the top c winners in the sorted order,
            the small (B, c) candidate matrix unsorted, and an exact
            full-dimension re-rank in input order.

Recall semantics are IVF's with cluster-adjacency routing: the probed set is
the primary's ``probes`` nearest clusters. Knobs: ``probes`` and ``c``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import exact_fp32, squared_norms
from gbnns_tpu_torch.kernels.scan_topk import (_round_up, gated_topm_scan,
                                               scan_width)
from gbnns_tpu_torch.kernels.topk import smallest_k
from gbnns_tpu_torch.search.rerank import rerank

# The scan's element types, by name.
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _chain_order(cent: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Greedy nearest-neighbour chain over centroids: a spatial traversal
    so that chain-adjacent clusters are geometric neighbours. Packing in
    this order puts a cluster's probe neighbourhood into few, adjacent
    chunks, which keeps the per-tile keep-mask unions small."""
    ncent = cent.shape[0]
    d2 = ((cent[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    visited = np.zeros(ncent, bool)
    cur = int(np.argmax(sizes))          # start at the densest region
    chain = [cur]
    visited[cur] = True
    for _ in range(ncent - 1):
        row = np.where(visited, np.inf, d2[cur])
        cur = int(np.argmin(row))
        visited[cur] = True
        chain.append(cur)
    return np.asarray(chain, np.int64)


def _pack_clusters(assign: np.ndarray, ncent: int, chunk: int,
                   cent: np.ndarray, lookahead: int = 8):
    """Chain-ordered sequential packing of whole clusters into chunks.

    Clusters are visited along the nearest-neighbour chain; each goes into
    the current chunk if it fits, else into the best-fitting of the next
    ``lookahead`` chain clusters first (gap filling), else a new chunk.
    Oversize clusters split at chunk boundaries.

    Returns (slot_of_row (n,) int64 — final corpus position per original
    row, n_chunks, cluster_chunk_mask (ncent, n_chunks) bool,
    chain_rank (ncent,) int64). Positions not covered by a row are
    padding.
    """
    n = assign.shape[0]
    sizes = np.bincount(assign, minlength=ncent)
    chain = _chain_order(cent, sizes)
    chain_rank = np.empty(ncent, np.int64)
    chain_rank[chain] = np.arange(ncent)

    caps: list[int] = [chunk]                        # free slots per chunk
    placed: list[list[tuple[int, int, int]]] = [[]]  # (cluster, lo, count)

    def put(c, off, take, j):
        placed[j].append((c, off, take))
        caps[j] -= take

    pending = [int(c) for c in chain if sizes[c] > 0]
    while pending:
        c = pending.pop(0)
        size = int(sizes[c])
        if size > caps[-1]:
            # gap-fill: pull forward the first of the next few chain
            # clusters that fits the current chunk's remaining space
            for li in range(min(lookahead, len(pending))):
                if sizes[pending[li]] <= caps[-1]:
                    pending.insert(0, c)
                    c = pending.pop(li + 1)
                    size = int(sizes[c])
                    break
            else:
                caps.append(chunk)
                placed.append([])
        off = 0
        while size > 0:                  # oversize clusters split here
            take = min(size, caps[-1])
            if take == 0:
                caps.append(chunk)
                placed.append([])
                continue
            put(c, off, take, len(caps) - 1)
            off += take
            size -= take
    n_chunks = len(caps)
    # rows of each cluster in original-corpus order
    row_of = np.argsort(assign, kind="stable")
    starts = np.zeros(ncent + 1, np.int64)
    starts[1:] = np.cumsum(sizes)
    slot_of_row = np.full(n, -1, np.int64)
    mask = np.zeros((ncent, n_chunks), bool)
    for j, pieces in enumerate(placed):
        pos = j * chunk
        for c, off, take in pieces:
            rows = row_of[starts[c] + off:starts[c] + off + take]
            slot_of_row[rows] = np.arange(pos, pos + take)
            mask[c, j] = True
            pos += take
    return slot_of_row, n_chunks, mask, chain_rank


@torch.no_grad()
def _plan_queries(ql, cent, cent_sq, neighbors, chunk_mask, chain_rank, *,
                  n_chunks: int, tq: int, probes: int):
    """Sort order + per-tile chunk keep mask via cluster-level routing.

    Returns (order (Bp,) int64 — sorted position -> padded input row,
    tile_mask (n_chunks * Bp/tq,) int32, entry ``j * b_tiles + i``).
    Padding rows (>= B) sort last and keep nothing. Queries sort by their
    primary's chain rank (a stable sort), so a tile's primaries are spatial
    neighbours and their probe sets overlap heavily."""
    B = ql.shape[0]
    Bp = _round_up(B, tq)
    ncent = cent.shape[0]
    dev = ql.device
    # ||c||^2 - 2 q.c: the per-query ||q||^2 cannot change the argmin
    with exact_fp32():
        d = cent_sq[None, :] - 2.0 * (ql @ cent.T)
    primary = torch.argmin(d, dim=1)                          # ties: first
    key = torch.full((Bp,), ncent, dtype=torch.int64, device=dev)
    key[:B] = chain_rank[primary]
    order = torch.sort(key, stable=True)[1]
    P = min(probes, neighbors.shape[1])
    nb = neighbors[primary][:, :P]                            # (B, P)
    keep = torch.zeros((Bp, n_chunks), dtype=torch.bool, device=dev)
    keep[:B] = chunk_mask[nb].any(dim=1)
    tile_keep = keep[order].view(Bp // tq, tq, n_chunks).any(dim=1)
    return order, tile_keep.T.reshape(-1).to(torch.int32)


class GatedScanIndex:
    """Flat index whose candidate scan is the cluster-gated scan.

    The same contract as ``FusedScanIndex`` (reduced-space scan, then an
    exact full-dimension re-rank), with two recall knobs: ``c`` (the
    re-rank pool) and ``probes`` (neighbour clusters scanned, IVF
    semantics). The reduced width is padded with zero columns to a width
    the kernels take (``scan_width``), which is exact. ``build_seconds``
    splits the constructor's time into k-means, assignment, packing (on the
    host) and upload.
    """

    def __init__(self, base_full, base_lo=None, *, metric: str = "l2",
                 ncent: int | None = None, scan_dtype="bfloat16",
                 fine: int = 32, m: int = 16, sub: int = 1024,
                 chunk: int = 16384, tq: int = 512, max_probes: int = 64,
                 seed: int = 0, kmeans_iters: int = 8,
                 kmeans_sample: int | None = 262_144, device=None):
        from gbnns_tpu_torch.build.kmeans import kmeans_assign, kmeans_fit

        if metric not in ("l2", "ip", "angular"):
            raise ValueError(f"unknown metric {metric!r}")
        if metric == "ip":
            # routing ranks clusters by L2 centroid distance, which under
            # raw inner-product scoring biases probes toward low-norm
            # clusters (a silent recall loss); angular (normalized) is
            # equivalent to L2 routing
            raise ValueError("GatedScanIndex does not support metric='ip': "
                             "cluster routing is L2-based; use metric="
                             "'angular' (normalized) or FusedScanIndex")
        self.scan_dtype = _DTYPES.get(scan_dtype, scan_dtype)
        if self.scan_dtype not in _DTYPES.values():
            raise ValueError(f"scan_dtype must be bfloat16, float16 or "
                             f"float32, got {scan_dtype!r}")
        self.device = dev = resolve_device(device)
        self.metric = metric
        self.fine = fine
        self.m = m
        self.sub = sub
        self.chunk = chunk
        self.tq = tq
        base_full = np.asarray(base_full, np.float32)
        lo = base_full if base_lo is None else np.asarray(base_lo,
                                                          np.float32)
        n, d_lo = lo.shape
        self.n = n
        self.d_lo = d_lo
        if ncent is None:
            # clusters of ~chunk/4 rows: small enough that `probes`
            # clusters cover a few chunks, big enough that a chunk holds
            # whole clusters
            ncent = -(-n // (chunk // 4))
        ncent = max(8, min(ncent, n))

        secs = self.build_seconds = {}
        t0 = time.perf_counter()
        cent = kmeans_fit(lo, ncent, iters=kmeans_iters, seed=seed,
                          sample=kmeans_sample, device=dev)
        t1 = time.perf_counter()
        assign = kmeans_assign(lo, cent, device=dev)
        t2 = time.perf_counter()
        secs.update(kmeans=t1 - t0, assign=t2 - t1)
        slot_of_row, self.n_chunks, cmask, chain_rank = _pack_clusters(
            assign, ncent, chunk, cent)
        n_pad = self.n_chunks * chunk

        # within-chunk fine-bin interleave: packed cluster runs are
        # contiguous and a fine bin keeps one winner, so consecutive rows
        # go to consecutive fine bins
        nbc = chunk // fine
        local = slot_of_row % chunk
        il_local = (local % nbc) * fine + local // nbc
        slot_il = (slot_of_row // chunk) * chunk + il_local

        final_order = np.full(n_pad, -1, np.int64)
        final_order[slot_il] = np.arange(n)
        real = final_order >= 0
        perm = np.where(real, final_order, -1).astype(np.int32)
        lo_pad = np.zeros((n_pad, d_lo), np.float32)
        lo_pad[real] = lo[final_order[real]]
        if metric == "l2":
            add = (lo_pad ** 2).sum(-1)
            scale = -2.0
        else:
            add = np.zeros(n_pad, np.float32)
            scale = -1.0
        add[~real] = np.inf

        # routing table: each cluster's max_probes nearest clusters
        # (itself first) by centroid distance
        c2 = ((cent[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
        P = min(max_probes, ncent)
        neighbors = np.argsort(c2, axis=1, kind="stable")[:, :P]
        t3 = time.perf_counter()
        self._set_state(
            perm=perm, x_lo=scale * lo_pad, addvec=add, neighbors=neighbors,
            chunk_mask=cmask, cent=cent, chain_rank=chain_rank,
            base_full=base_full,
            stats=dict(n=n, ncent=int(ncent), n_chunks=self.n_chunks,
                       pack_padding=round(1.0 - n / n_pad, 4),
                       chunks_per_cluster=round(float(cmask.sum(1).mean()),
                                                3)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs.update(pack=t3 - t2, upload=time.perf_counter() - t3)

    def _set_state(self, *, perm, x_lo, addvec, neighbors, chunk_mask, cent,
                   chain_rank, base_full, stats, cent_sq=None) -> None:
        """Put the index's arrays on its device (numpy in). ``x_lo`` is
        prescaled; it is stored in ``scan_dtype`` and padded with zero
        columns to a kernel width."""
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.array(a)).to(dev, dtype)

        x = np.asarray(x_lo, np.float32)
        width = scan_width(x.shape[1])
        if width != x.shape[1]:
            x = np.pad(x, ((0, 0), (0, width - x.shape[1])))
        self.perm = put(perm, torch.int32)          # kernel pos -> orig id
        self.x_lo = put(x, self.scan_dtype)
        self.addvec = put(addvec, torch.float32)
        self.neighbors = put(neighbors, torch.int64)
        self.chunk_mask = put(chunk_mask, torch.bool)
        self.cent = put(cent, torch.float32)
        self.cent_sq = (squared_norms(self.cent) if cent_sq is None
                        else put(cent_sq, torch.float32))
        self.chain_rank = put(chain_rank, torch.int64)
        self.base_full = put(base_full, torch.float32)   # original order
        self.base_sq = squared_norms(self.base_full)
        self.stats = dict(stats)

    @classmethod
    def from_jax(cls, jidx, *, device=None) -> "GatedScanIndex":
        """The port's index over the JAX package's ``GatedScanIndex``: the
        same packing, corpus, routing and centroids, read through numpy, so
        both packages search one state."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.build_seconds = {}
        for name in ("metric", "fine", "m", "sub", "chunk", "tq", "n",
                     "n_chunks"):
            setattr(self, name, getattr(jidx, name))
        x = np.asarray(jidx.x_lo)
        self.scan_dtype = _DTYPES[x.dtype.name]
        self.d_lo = x.shape[1]
        self._set_state(
            perm=np.asarray(jidx.perm), x_lo=x.astype(np.float32),
            addvec=np.asarray(jidx.addvec),
            neighbors=np.asarray(jidx.neighbors),
            chunk_mask=np.asarray(jidx.chunk_mask), cent=np.asarray(jidx.cent),
            cent_sq=np.asarray(jidx.cent_sq),
            chain_rank=np.asarray(jidx.chain_rank),
            base_full=np.asarray(jidx.base_full), stats=jidx.stats)
        return self

    def plan(self, queries_lo, *, probes: int = 16):
        """The query plan of a search: ``(order (Bp,), tile_mask, tq)``."""
        ql = torch.as_tensor(queries_lo, dtype=torch.float32,
                             device=self.device)
        B = ql.shape[0]
        tq = min(self.tq, _round_up(B, 8 if self.device.type == "cpu"
                                    else 128))
        order, tile_mask = _plan_queries(
            ql, self.cent, self.cent_sq, self.neighbors, self.chunk_mask,
            self.chain_rank, n_chunks=self.n_chunks, tq=tq, probes=probes)
        return order, tile_mask, tq

    def scan_queries(self, ql: torch.Tensor, order: torch.Tensor):
        """The padded, sorted queries in the scan's type and width."""
        if ql.shape[1] != self.d_lo:
            raise ValueError(f"queries have {ql.shape[1]} reduced dims, the "
                             f"index {self.d_lo}")
        B, width = ql.shape[0], self.x_lo.shape[1]
        qlp = torch.nn.functional.pad(ql, (0, width - self.d_lo, 0,
                                           order.shape[0] - B))
        return qlp[order].to(self.scan_dtype)

    @torch.no_grad()
    def search(self, queries_full, queries_lo=None, *, k: int = 10,
               c: int = 32, probes: int = 16, merge: str = "approx",
               return_kept_frac: bool = False):
        """Top-k ``(ids (B, k) int32, dists (B, k) f32)`` after the exact
        re-rank of the ``c`` best gated-scan winners; with
        ``return_kept_frac`` also the kept share of (chunk x tile) cells.
        ``merge`` "exact" and "approx" are both an exact selection with
        ties to the lower column: the TPU's approximate top-k has no
        counterpart here."""
        if merge not in ("exact", "approx"):
            raise ValueError(f"unknown merge {merge!r}")
        qf = torch.as_tensor(queries_full, dtype=torch.float32,
                             device=self.device)
        ql = qf if queries_lo is None else torch.as_tensor(
            queries_lo, dtype=torch.float32, device=self.device)
        B = ql.shape[0]
        order, tile_mask, tq = self.plan(ql, probes=probes)
        vals, ids = gated_topm_scan(
            self.scan_queries(ql, order), self.x_lo, self.addvec, tile_mask,
            metric=self.metric, fine=self.fine, m=self.m, sub=self.sub,
            chunk=self.chunk, tq=tq)
        sel_vals, sel = smallest_k(vals, min(c, vals.shape[1]))
        cand_pos = torch.gather(ids, 1, sel)
        # +inf winners are skipped-cell sentinels (id -1) or packing
        # padding (perm -1): both become -1, which the re-rank drops
        valid = torch.isfinite(sel_vals) & (cand_pos >= 0)
        pid = self.perm[cand_pos.clamp(min=0).long()]
        cand_sorted = torch.where(valid & (pid >= 0), pid, -1)
        # unsort the small (B, c) candidate matrix and re-rank in input
        # order: the full-dimension queries never ride through the sort
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        cand = cand_sorted[inv[:B]]
        ids_o, d_o = rerank(qf, self.base_full, cand, k, metric=self.metric,
                            base_sqnorms=self.base_sq)
        if return_kept_frac:
            return ids_o, d_o, float(tile_mask.float().mean())
        return ids_o, d_o
