"""Sharded search over a mesh of devices, driven by one process.

Port of ``gbnns_tpu/search/sharded.py``. The corpus (search-space and
full-dimension vectors) and its kNN graph are split into P contiguous
shards, one per mesh device; each shard's graph is local (its own vectors,
local ids), so the shards build independently and no device holds the whole
index. Queries are replicated: each shard computes its candidates (a walk
of its subgraph, or a scan of its rows) and re-ranks them at full dimension
on its device, so the only traffic between shards is the (B, k) id/distance
pairs, which are copied to the first mesh device and merged there into the
global top k.

The JAX package runs the shards as one ``shard_map`` program. This module
keeps its single-controller design: one process, and one thread, dispatch
every shard in turn, and a copy of each shard's (B, k) pairs to
``mesh.devices[0]`` does the ``all_gather``'s work. A library call that the
pipeline and the CLI make from one process needs no process group.
``make_mesh(n, device=...)`` puts all n shards on one device: the CPU mesh
the tests use, and the one-card mesh of ``chip_smoke.py``.

Engines: ``graph`` (the lockstep walker), ``flat`` (exact fp32 scan),
``fused`` (the binned scan K1 and top-c merge K2 per shard, at the JAX
module's own geometry) and ``graph_pallas`` (the payload walker, whose hop
fetches its rows with K3, with per-shard centroid entries).
"""

from __future__ import annotations

import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import exact_fp32, squared_norms
from gbnns_tpu_torch.kernels.topk import smallest_k
from gbnns_tpu_torch.search.rerank import rerank

ENGINES = ("graph", "flat", "fused", "graph_pallas")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: the device of each shard, in shard order. A device
    may appear more than once (several shards on one card)."""

    devices: tuple[torch.device, ...]
    axis: str = "shards"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "shards", *,
              device=None) -> Mesh:
    """The first ``n_devices`` cards (all of them when None), as the JAX
    package's ``jax.devices()[:n_devices]``; with ``device`` ("cpu",
    "cuda:0"), ``n_devices`` shards (1 when None) all on that one device."""
    if device is not None:
        dev = resolve_device(device)
        return Mesh(devices=(dev,) * (n_devices or 1), axis=axis)
    resolve_device(None)                      # raises without a card
    count = torch.cuda.device_count()
    if n_devices is not None and n_devices > count:
        raise ValueError(f"a mesh of {n_devices} cards asked for, "
                         f"{count} present; pass device='cuda:0' to put "
                         f"every shard on one card")
    n = count if n_devices is None else n_devices
    return Mesh(devices=tuple(torch.device("cuda", i) for i in range(n)),
                axis=axis)


@dataclasses.dataclass
class ShardedIndex:
    """Per-shard tensors, shard p's on ``mesh.devices[p]``; shard p holds
    global ids [p * n_shard, (p + 1) * n_shard)."""

    base_lo: tuple[torch.Tensor, ...]    # (n_shard, d_lo) f32 search space
    base_full: tuple[torch.Tensor, ...]  # (n_shard, d) f32 for the re-rank
    graph: tuple[torch.Tensor, ...]      # (n_shard, K) int32 local ids
    n: int                               # corpus size before padding
    n_shard: int
    mesh: Mesh
    axis: str = "shards"
    # payload walker (engine="graph_pallas"): one HopPayload a shard and its
    # (K, d_lo, vec_words, bf16); None without with_payload
    payload: tuple | None = None
    payload_meta: tuple | None = None
    # per-shard centroid entries (search.entries.CentroidEntries' arrays)
    cent: tuple[torch.Tensor, ...] | None = None      # (ncent, d_lo)
    cent_sq: tuple[torch.Tensor, ...] | None = None   # (ncent,)
    cent_ids: tuple[torch.Tensor, ...] | None = None  # (ncent,) local ids
    # the re-rank's f32 norms of base_full, taken once
    base_sq: tuple[torch.Tensor, ...] = ()


def _shard_rows(a: np.ndarray, p: int, n_shard: int) -> np.ndarray:
    return a[p * n_shard:(p + 1) * n_shard]


@torch.no_grad()
def _batched_shard_candidates(base_lo: np.ndarray, Pn: int, n_shard: int,
                              K: int, *, metric: str, mesh: Mesh,
                              q_chunk: int = 4096) -> np.ndarray:
    """Exact per-shard kNN candidates, each shard on its device, its node
    axis in ``q_chunk`` blocks (one (q_chunk, n_shard) score tile live at a
    time). The JAX module's scores, ``|q|² - 2 q·x + |x|²`` (l2) or
    ``-q·x``, with fp32 products, and its order: ties to the lower index.
    Returns (Pn, n_shard, kk) int32 local ids (self included),
    kk = min(K + 1, n_shard)."""
    kk = min(K + 1, n_shard)
    qc = min(q_chunk, n_shard)
    out = np.empty((Pn, n_shard, kk), np.int32)
    for p in range(Pn):
        x = torch.from_numpy(_shard_rows(base_lo, p, n_shard)).to(
            mesh.devices[p])
        xsq = squared_norms(x)
        for lo in range(0, n_shard, qc):
            qb = x[lo:lo + qc]
            with exact_fp32():
                dot = qb @ x.T
            if metric == "l2":
                d = squared_norms(qb)[:, None] - 2.0 * dot + xsq[None, :]
            else:                                   # ip / angular
                d = -dot
            out[p, lo:lo + qc] = smallest_k(d, kk)[1].cpu().numpy()
    return out


def build_sharded_index(base_full, K: int, mesh: Mesh, *,
                        base_lo=None, metric: str = "l2",
                        axis: str = "shards", with_graph: bool = True,
                        with_payload: bool = False,
                        vec_dtype: str = "bfloat16", ncent: int = 0,
                        seed: int = 0, parallel_build: bool = True,
                        build_kwargs: dict[str, Any] | None = None) -> ShardedIndex:
    """Split the corpus into contiguous shards, one a mesh device, and build
    an independent kNN subgraph for each (local ids). The tail shard is
    padded with sentinel rows: a far constant for l2, zeros for ip and
    angular; the search masks every global id >= n besides.

    ``with_graph=False`` skips the subgraphs of an index that is only
    scanned (engines flat and fused): graph becomes (n_shard, 0).
    ``with_payload=True`` packs each shard's subgraph and reduced vectors
    into hop payload rows (``walker_payload.pack_hop_payload``) and, with
    ``ncent`` > 0, fits centroid entries per shard (seed ``seed + p``), for
    ``engine="graph_pallas"``.

    The default exact build takes every shard's candidates from one exact
    sweep a shard, then drops the self edge, adds reverse edges and repairs
    reachability per shard in a thread pool; other ``build_kwargs`` (an
    approximate or fused sweep) take ``build_knn_graph`` shard by shard."""
    from gbnns_tpu_torch.build.knn_graph import (_drop_self,
                                                 add_reverse_edges,
                                                 build_knn_graph,
                                                 ensure_connected)

    base_full = np.asarray(base_full, dtype=np.float32)
    base_lo = base_full if base_lo is None else np.asarray(base_lo, np.float32)
    n, d = base_full.shape
    Pn = mesh.size
    n_shard = -(-n // Pn)
    pad = Pn * n_shard - n
    if pad:
        # sentinels: for l2 a far constant keeps them out of every neighbour
        # list; for ip/angular a far row would have a huge inner product,
        # so zeros (score 0) instead
        if metric in ("ip", "angular"):
            fill_full = np.zeros((pad, d), np.float32)
            fill_lo = np.zeros((pad, base_lo.shape[1]), np.float32)
        else:
            far = np.abs(base_full).max() * 1e3 + 1e3
            fill_full = np.full((pad, d), far, np.float32)
            fill_lo = np.full((pad, base_lo.shape[1]), far, np.float32)
        base_full = np.concatenate([base_full, fill_full], axis=0)
        base_lo = np.concatenate([base_lo, fill_lo], axis=0)

    if with_graph:
        kw = dict(build_kwargs or {})
        batched = (parallel_build and Pn > 1 and K + 1 <= n_shard
                   and kw.get("exact", True)
                   and kw.get("backend", "xla") == "xla")
        if batched:
            cand = _batched_shard_candidates(
                base_lo, Pn, n_shard, K, metric=metric, mesh=mesh,
                q_chunk=int(kw.get("node_chunk", 4096)))

            def finish(p):
                # O(E) numpy a shard, threaded so one shard's BFS overlaps
                # the next one's BLAS sweeps (which release the GIL)
                g = _drop_self(cand[p], 0)
                g = add_reverse_edges(g, frac=kw.get("reverse_frac", 0.5))
                if kw.get("connect", True):
                    g = ensure_connected(_shard_rows(base_lo, p, n_shard), g,
                                         metric=metric)
                return g

            with ThreadPoolExecutor(max_workers=min(Pn, 8)) as ex:
                graphs = list(ex.map(finish, range(Pn)))
        else:
            graphs = [build_knn_graph(_shard_rows(base_lo, p, n_shard), K,
                                      metric=metric, device=mesh.devices[p],
                                      **kw)
                      for p in range(Pn)]
    else:
        graphs = [np.zeros((n_shard, 0), np.int32)] * Pn

    payload = payload_meta = cent = cent_sq = cent_ids = None
    if with_payload:
        if not with_graph:
            raise ValueError("with_payload=True needs with_graph=True")
        from gbnns_tpu_torch.search.walker_payload import pack_hop_payload

        payload = tuple(pack_hop_payload(graphs[p],
                                         _shard_rows(base_lo, p, n_shard),
                                         vec_dtype=vec_dtype,
                                         device=mesh.devices[p])
                        for p in range(Pn))
        hp = payload[0]
        payload_meta = (hp.K, hp.d, hp.vec_words, hp.bf16)
    if ncent:
        from gbnns_tpu_torch.search.entries import CentroidEntries

        ces = [CentroidEntries.build(_shard_rows(base_lo, p, n_shard),
                                     ncent=ncent, metric=metric, seed=seed + p,
                                     device=mesh.devices[p])
               for p in range(Pn)]
        cent = tuple(ce.centroids for ce in ces)
        cent_sq = tuple(ce.cent_sq for ce in ces)
        cent_ids = tuple(ce.node_ids for ce in ces)

    def put(a, p, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(
            _shard_rows(a, p, n_shard), dtype)).to(mesh.devices[p])

    full = tuple(put(base_full, p) for p in range(Pn))
    return ShardedIndex(
        base_lo=tuple(put(base_lo, p) for p in range(Pn)), base_full=full,
        graph=tuple(torch.from_numpy(np.asarray(g, np.int32)).to(dev)
                    for g, dev in zip(graphs, mesh.devices)),
        n=n, n_shard=n_shard, mesh=mesh, axis=axis,
        payload=payload, payload_meta=payload_meta,
        cent=cent, cent_sq=cent_sq, cent_ids=cent_ids,
        base_sq=tuple(squared_norms(f) for f in full))


def sharded_from_jax(jidx, mesh: Mesh) -> ShardedIndex:
    """The port's index over the JAX package's ``ShardedIndex`` (graphs,
    payload re-rowed, centroids, corpora), read through numpy, its shard p
    put on ``mesh.devices[p]``: two searches of one index, not two
    builds."""
    from gbnns_tpu_torch.search.walker_payload import payload_from_jax

    Pn = int(np.asarray(jidx.base_lo).shape[0])
    if Pn != mesh.size:
        raise ValueError(f"the JAX index has {Pn} shards, the mesh "
                         f"{mesh.size} devices")

    def shards(a, dtype=np.float32):
        if a is None:
            return None
        a = np.asarray(a)
        return tuple(torch.tensor(np.asarray(a[p], dtype),
                                  device=mesh.devices[p]) for p in range(Pn))

    payload = None
    if jidx.payload is not None:
        K, d, vec_words, bf16 = jidx.payload_meta
        data = np.asarray(jidx.payload)
        payload = tuple(payload_from_jax(types.SimpleNamespace(
            data=data[p], n=jidx.n_shard, K=K, d=d, vec_words=vec_words,
            bf16=bf16), device=mesh.devices[p]) for p in range(Pn))
    full = shards(jidx.base_full)
    return ShardedIndex(
        base_lo=shards(jidx.base_lo), base_full=full,
        graph=shards(jidx.graph, np.int32), n=int(jidx.n),
        n_shard=int(jidx.n_shard), mesh=mesh, axis=jidx.axis,
        payload=payload,
        payload_meta=(None if jidx.payload_meta is None
                      else tuple(jidx.payload_meta)),
        cent=shards(jidx.cent), cent_sq=shards(jidx.cent_sq),
        cent_ids=shards(jidx.cent_ids, np.int32),
        base_sq=tuple(squared_norms(f) for f in full))


def fused_geometry(n_shard: int, ef: int) -> tuple[int, int, int]:
    """``(f_chunk, f_bin, f_pad)`` of the fused engine's per-shard scan, as
    the JAX module picks them: the chunk is the shard size rounded up to a
    power of two within [128, 16384]; the bin is chunk / max(8, ef) within
    [8, 1024], rounded down to a power of two (so it divides the chunk);
    the shard is padded to a whole number of chunks."""
    f_chunk = min(16384, max(128, 1 << (n_shard - 1).bit_length()))
    f_bin = max(8, min(1024, f_chunk // max(8, ef)))
    f_bin = 1 << (f_bin.bit_length() - 1)
    f_pad = -(-n_shard // f_chunk) * f_chunk
    return f_chunk, f_bin, f_pad


def fused_operands(q: torch.Tensor, base_lo: torch.Tensor, *, metric: str,
                   scan_dtype: str, f_pad: int, n_real: int | None = None):
    """The fused engine's scan operands for one shard, by the JAX module's
    recipe: ``(q_scan, x, addvec, alpha)`` for ``kernels.scan_topk.
    binned_scan``, the width padded with zero columns to one the kernel
    takes (exact: zeros add nothing to a dot product or a norm).

    bfloat16: the corpus prescaled by -2 (l2) or -1 as bf16, addvec the
    fp32 norms of the unscaled rows (0 for ip/angular), +inf on the
    padding rows, alpha None. int8: a per-shard scale sxs = 127 / max|x|
    and a per-query one sqq = 127 / max|q|, addvec the norms of the
    dequantized rows, and alpha = scale / (sxs * sqq), the JAX module's
    ``qshift``.

    sxs is taken over the shard's first ``n_real`` rows (all when None),
    its corpus rows. The JAX module takes it over the sentinel rows too,
    whose far constant (1e3 times the largest |x|) then rounds every real
    row of the tail shard to 0 in l2; here the sentinels clip to ±127 and
    stay out of the result, as every id >= n does."""
    from gbnns_tpu_torch.kernels.scan_topk import scan_width

    n_shard, d_lo = base_lo.shape
    width = scan_width(d_lo)
    pad = f_pad - n_shard
    scale = -2.0 if metric == "l2" else -1.0
    inf_pad = torch.full((pad,), float("inf"), device=base_lo.device)
    if scan_dtype == "int8":
        sxs = 127.0 / torch.clamp(base_lo[:n_real].abs().max(), min=1e-30)
        xi = torch.clamp(torch.round(base_lo * sxs), -127, 127)
        xqs = ((xi / sxs) ** 2).sum(-1)
        add = xqs if metric == "l2" else torch.zeros_like(xqs)
        sqq = 127.0 / torch.clamp(q.abs().amax(dim=1), min=1e-30)
        q_scan = torch.clamp(torch.round(q * sqq[:, None]), -127, 127)
        dtype, alpha = torch.int8, scale / (sxs * sqq)
        x = xi
    else:
        sq = (base_lo * base_lo).sum(-1)
        add = sq if metric == "l2" else torch.zeros_like(sq)
        x, q_scan = scale * base_lo, q
        dtype, alpha = torch.bfloat16, None
    x = torch.nn.functional.pad(x, (0, width - d_lo, 0, pad)).to(dtype)
    q_scan = torch.nn.functional.pad(q_scan, (0, width - d_lo)).to(dtype)
    return q_scan, x, torch.cat([add, inf_pad]), alpha


@torch.no_grad()
def _shard_candidates(index: ShardedIndex, p: int, q: torch.Tensor, *,
                      engine: str, ef: int, num_entries: int, max_hops: int,
                      metric: str, scan_dtype: str) -> torch.Tensor:
    """Shard ``p``'s candidate pool for queries ``q`` on its device: (B, C)
    local ids."""
    base_lo = index.base_lo[p]
    if engine == "graph_pallas":
        from gbnns_tpu_torch.search.entries import CentroidEntries
        from gbnns_tpu_torch.search.walker import default_entry_ids
        from gbnns_tpu_torch.search.walker_payload import beam_search_payload

        if index.cent is not None:
            ce = CentroidEntries(centroids=index.cent[p],
                                 cent_sq=index.cent_sq[p],
                                 node_ids=index.cent_ids[p], metric=metric)
            ent = ce.query_entries(q, min(num_entries, ef))
        else:
            ent = default_entry_ids(index.n_shard, min(num_entries, ef))
        return beam_search_payload(q, index.payload[p], base_lo, ent, ef=ef,
                                   metric=metric, max_hops=max_hops).ids
    if engine == "fused":
        from gbnns_tpu_torch.kernels.scan_topk import binned_scan, merge_topc

        f_chunk, f_bin, f_pad = fused_geometry(index.n_shard, ef)
        q_scan, x, add, alpha = fused_operands(
            q, base_lo, metric=metric, scan_dtype=scan_dtype, f_pad=f_pad,
            n_real=min(index.n_shard, index.n - p * index.n_shard))
        kind = (dict(quant=True) if scan_dtype == "int8"
                else dict(prescaled=True))
        vals, ids = binned_scan(q_scan, x, add, alpha, metric=metric,
                                bin_size=f_bin, chunk=f_chunk,
                                tq=min(512, q.shape[0]), packed=True,
                                transpose=False, **kind)
        # K2 on the scan's bin-major winners, as the single-card engine
        return merge_topc(vals, ids, min(ef, vals.shape[0]),
                          valid_b=q.shape[0])[1]
    if engine == "flat":
        from gbnns_tpu_torch.kernels.topk import knn_chunked

        return knn_chunked(q, base_lo, ef, metric=metric, chunk=65536)[1]
    from gbnns_tpu_torch.search.walker import beam_search, default_entry_ids

    entry = default_entry_ids(index.n_shard, min(num_entries, ef))
    return beam_search(q, base_lo, index.graph[p], entry, ef=ef,
                       metric=metric, max_hops=max_hops).ids


@torch.no_grad()
def sharded_search(index: ShardedIndex, queries, k: int, *, ef: int,
                   num_entries: int = 32, max_hops: int = 256,
                   metric: str = "l2", engine: str = "graph",
                   queries_full=None, scan_dtype: str = "bfloat16",
                   rerank_metric: str | None = None):
    """Search every shard and merge: ``(ids (B, k) int32, dists (B, k)
    f32)`` with global ids, on ``mesh.devices[0]``.

    Per shard, on its device: the candidates of ``engine``, the exact
    full-dimension re-rank of them, and global ids with every id >= n (a
    sentinel) masked to -1 and +inf. The shards' pairs are then copied to
    the first device and merged in the order of JAX's ``lax.top_k`` over
    the shard-major (B, P * k) pairs: ties to the lower shard, then the
    lower slot. ``queries`` are in the search (reduced) space; pass
    ``queries_full`` whenever the index was built with a reduced
    ``base_lo``. ``engine="graph_pallas"`` needs an index built with
    ``with_payload=True``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "graph" and index.graph[0].shape[-1] == 0:
        raise ValueError("index was built with with_graph=False; "
                         "rebuild with with_graph=True for engine='graph'")
    if engine == "graph_pallas" and index.payload is None:
        raise ValueError("index was built without hop payloads; rebuild "
                         "with with_payload=True for engine='graph_pallas'")
    if engine == "fused" and scan_dtype not in ("bfloat16", "int8"):
        raise ValueError(f"scan_dtype must be bfloat16 or int8, "
                         f"got {scan_dtype!r}")
    rr_metric = rerank_metric or metric
    q_all = torch.as_tensor(queries, dtype=torch.float32)
    qf_all = (q_all if queries_full is None
              else torch.as_tensor(queries_full, dtype=torch.float32))
    if qf_all.shape[1] != index.base_full[0].shape[-1]:
        raise ValueError(
            f"re-rank needs full-dim queries: got {qf_all.shape[1]}, index "
            f"full dim is {index.base_full[0].shape[-1]} (pass "
            f"queries_full=...)")
    dev0 = index.mesh.devices[0]
    placed = {}   # the queries, uploaded once to each distinct device
    all_ids, all_d = [], []
    for p, dev in enumerate(index.mesh.devices):
        if dev not in placed:
            placed[dev] = (q_all.to(dev), qf_all.to(dev))
        q, qf = placed[dev]
        cand = _shard_candidates(index, p, q, engine=engine, ef=ef,
                                 num_entries=num_entries, max_hops=max_hops,
                                 metric=metric, scan_dtype=scan_dtype)
        ids, dists = rerank(qf, index.base_full[p], cand, k, metric=rr_metric,
                            base_sqnorms=index.base_sq[p])
        gids = torch.where(ids >= 0, ids + p * index.n_shard, -1)
        valid = (ids >= 0) & (gids < index.n)
        all_ids.append(torch.where(valid, gids, -1).to(dev0))
        all_d.append(torch.where(valid, dists, float("inf")).to(dev0))
    B = q_all.shape[0]
    flat_ids = torch.stack(all_ids, 1).reshape(B, -1)   # (B, P * k)
    flat_d = torch.stack(all_d, 1).reshape(B, -1)
    vals, sel = smallest_k(flat_d, k)
    return torch.gather(flat_ids, 1, sel).to(torch.int32), vals
