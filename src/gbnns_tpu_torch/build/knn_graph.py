"""kNN-graph construction and its host passes.

Port of ``gbnns_tpu/build/knn_graph.py``. The all-pairs sweep runs on the
device in node chunks: ``backend="xla"`` is the exact sweep (fp32 products
and ``torch.topk`` over corpus chunks, ``kernels.topk.knn_fused``), and
``backend="fused"`` the binned scan (kernel K1, bf16) whose bin winners the
top-c merge (kernel K2) reduces to K+1 candidates per node, without the
(B, n) scores ever reaching device memory. The self edge is dropped, half of
each row is given to reverse edges, and bridge edges make every node
reachable from the walker's entries. Those passes are numpy on the host,
copied from the JAX module (which imports JAX at its top).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device


def build_knn_graph(base, K: int, *, metric: str = "l2",
                    node_chunk: int = 8192, chunk: int = 65536,
                    exact: bool = True, recall_target: float = 0.99,
                    dtype=None, precision: str | None = None,
                    connect: bool = True, backend: str = "xla",
                    reverse_frac: float = 0.5, verbose: bool = False,
                    stats: dict | None = None, device=None) -> np.ndarray:
    """Build the kNN graph of ``base (n, d)``: (n, K) int32 neighbour ids.

    Self edges are excluded by taking top-(K+1) and dropping each node's own
    id; where the fused scan lost it to a bin collision, the worst candidate
    goes instead. ``backend``: "xla" (exact) or "fused" (binned scan, the
    fast approximate sweep).

    The JAX package's keywords, in its order: ``exact`` and
    ``recall_target`` are accepted and selection stays exact (the TPU's
    approximate top-k has no counterpart here); ``precision`` is accepted
    and the exact sweep always runs full fp32 with TF32 off, as JAX's
    ``"highest"``; ``dtype`` (a torch dtype, its name, or a numpy dtype
    such as ``jnp.bfloat16``) casts the exact sweep's inputs before the
    distances, so ``bfloat16`` gives the graph of the bf16-rounded vectors
    with fp32 sums. As in JAX, ``dtype`` does not reach the fused backend.
    ``stats``, when given, receives the seconds of the sweep (``scan_s``),
    of ``add_reverse_edges`` (``reverse_s``) and of ``ensure_connected``
    (``connect_s``).
    """
    if backend == "pallas":
        raise ValueError(
            "backend='pallas' was demoted in round 4 (loses at every "
            "measured k — results/build_backend_ab.json); use "
            "backend='xla' (exact) or 'fused' (fast approx), or call "
            "kernels.distance_topk.knn_topk directly")
    if backend not in ("xla", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    base = np.asarray(base, np.float32)
    n = base.shape[0]
    if K >= n:
        raise ValueError(f"K={K} >= n={n}")
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    if backend == "fused":
        ids_all = _build_fused(base, K, metric=metric, node_chunk=node_chunk,
                               verbose=verbose, device=dev)
    else:
        from gbnns_tpu_torch.kernels.topk import knn_fused

        xb = torch.from_numpy(base).to(dev)
        if dtype is not None:
            xb = xb.to(_torch_dtype(dtype))
        _, ids = knn_fused(xb, xb, K + 1, metric=metric, chunk=chunk,
                           q_chunk=node_chunk, exact=exact,
                           recall_target=recall_target, precision=precision)
        ids_all = ids.cpu().numpy()
    stats["scan_s"] = time.perf_counter() - t0
    graph = _drop_self(ids_all, 0)
    t0 = time.perf_counter()
    if reverse_frac > 0:
        graph = add_reverse_edges(graph, frac=reverse_frac)
    stats["reverse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if connect:
        graph = ensure_connected(base, graph, metric=metric, verbose=verbose)
    stats["connect_s"] = time.perf_counter() - t0
    if verbose:
        print(f"  knn-graph {backend}: sweep {stats['scan_s']:.2f} s, "
              f"reverse edges {stats['reverse_s']:.2f} s, connect "
              f"{stats['connect_s']:.2f} s", flush=True)
    return graph


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, its name, or a numpy dtype (also
    ml_dtypes' ``bfloat16``, which JAX's ``jnp.bfloat16`` is)."""
    if isinstance(dtype, torch.dtype):
        found = dtype
    else:
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        found = getattr(torch, name, None)
    if not isinstance(found, torch.dtype) or not found.is_floating_point:
        raise ValueError(f"dtype must be a float type, got {dtype!r}")
    return found


# The fused sweep pads its corpus to a multiple of this chunk (the JAX
# module's), which the scan checks as the Pallas one does.
FUSED_CHUNK = 16384


def fused_bin_size(n: int, K: int) -> int:
    """The fused sweep's bin: 1024 rows, halved for tiny corpora so that a
    node keeps enough bins (at least 4 (K + 1)), down to 8."""
    bin_size = 1024
    while n < 4 * bin_size * (K + 1):
        bin_size //= 2
        if bin_size <= 8:
            break
    return max(8, bin_size)


@torch.no_grad()
def fused_operands(base: np.ndarray, K: int, *, metric: str = "l2",
                   device=None):
    """The fused sweep's scan operands on the device: ``(nodes (n, w) f32,
    corpus (n_pad, w) bf16 prescaled, addvec (n_pad,) f32, bin_size)``, w
    the kernel's width. A node chunk's queries are its rows of ``nodes`` in
    bf16."""
    from gbnns_tpu_torch.kernels.scan_topk import scan_width

    dev = resolve_device(device)
    n, d = base.shape
    chunk = FUSED_CHUNK
    bin_size = fused_bin_size(n, K)
    n_pad = -(-n // chunk) * chunk if n >= chunk else chunk
    # zero columns up to the kernel's width add nothing to a dot product
    lo_pad = np.zeros((n_pad, scan_width(d)), np.float32)
    lo_pad[:n, :d] = base
    if metric == "l2":
        add = (lo_pad ** 2).sum(-1)
    else:
        add = np.zeros(n_pad, np.float32)
    add[n:] = np.inf
    scale = -2.0 if metric == "l2" else -1.0
    x = torch.from_numpy(scale * lo_pad).to(torch.bfloat16).to(dev)  # exact
    add_t = torch.from_numpy(add.astype(np.float32)).to(dev)
    q_all = torch.from_numpy(lo_pad[:n]).to(dev)
    return q_all, x, add_t, bin_size


@torch.no_grad()
def _build_fused(base: np.ndarray, K: int, *, metric: str,
                 node_chunk: int = 16384, verbose: bool = False,
                 device=None) -> np.ndarray:
    """Approximate kNN rows by the binned scan: each node chunk scans the
    whole corpus, one winner per bin of 1024 rows (K1, bf16, packed keys),
    then the top-(K+1) merge of the bin winners (K2). In-bin collisions lose
    ~K²/2/(n/1024) edges per node (~0.5 at n = 1M, K = 32); reverse edges
    and the reachability repair absorb them. Returns (n, K+1) candidate ids
    (self included)."""
    from gbnns_tpu_torch.kernels.scan_topk import binned_scan, merge_topc

    n = base.shape[0]
    q_all, x, add_t, bin_size = fused_operands(base, K, metric=metric,
                                               device=device)
    parts = []
    t0 = time.perf_counter()
    for off in range(0, n, node_chunk):
        hi = min(off + node_chunk, n)
        raw_v, raw_i = binned_scan(q_all[off:hi].to(torch.bfloat16), x, add_t,
                                   metric=metric, bin_size=bin_size,
                                   chunk=FUSED_CHUNK, tq=min(512, node_chunk),
                                   packed=True, prescaled=True,
                                   transpose=False)
        # bin-major winners straight into the merge, as in the JAX module
        _, cand = merge_topc(raw_v, raw_i, min(K + 1, raw_v.shape[0]),
                             valid_b=hi - off)
        parts.append(cand)
        if verbose:
            print(f"  fused knn-graph {hi}/{n} ({hi / n:.0%}) "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
    out = torch.cat(parts).cpu().numpy()
    if out.shape[1] < K + 1:  # degenerate tiny-corpus case: pad with wrap
        pad = np.tile(out[:, -1:], (1, K + 1 - out.shape[1]))
        out = np.concatenate([out, pad], axis=1)
    return out


def add_reverse_edges(graph: np.ndarray, frac: float = 0.5) -> np.ndarray:
    """Degree-budgeted symmetrization: keep the nearest (1-frac)·K own kNN
    edges and fill the rest of each row with reverse (in-) edges, falling
    back to the displaced kNN edges where a node has too few in-neighbors.

    Why: a pure kNN digraph descends into cluster cores and cannot climb
    back out — measured on the 1M synthetic corpus, 93% of nodes were not
    directed-reachable from 32 spread entry points, which both caps recall
    and makes reachability repair take many rounds. Mixing in reverse edges
    (the NSG/Vamana-style degree-bounded symmetrization) restores two-way
    navigability at unchanged index memory (degree stays K).
    """
    n, K = graph.shape
    keep = K - int(round(K * frac))
    if keep >= K:
        return np.array(graph, copy=True)
    indptr, rsrc = _reverse_csr(graph)
    counts = indptr[1:] - indptr[:-1]
    new = np.array(graph, copy=True)
    if rsrc.size == 0:
        # No valid edges anywhere (all -1 adjacency): nothing to fill, and
        # the vectorized gather below would index the empty rsrc eagerly.
        return new
    # One vectorized shot over the (n, K-keep) tail instead of K-keep
    # boolean-mask passes (the loop was ~8 s of the 1M build's host tail):
    # slot j of node v gets its j-th in-neighbor when it has one, else
    # keeps the displaced kNN edge already in place.
    m = K - keep
    cols = np.arange(m, dtype=np.int64)[None, :]
    avail = cols < counts[:, None]
    src_idx = np.where(avail, indptr[:-1, None] + cols, 0)
    new[:, keep:] = np.where(avail, rsrc[src_idx], new[:, keep:])
    return new


def _drop_self(ids: np.ndarray, row_offset: int) -> np.ndarray:
    """From (m, K+1) candidate ids, remove each row's own id; keep K.

    If the self id is absent (possible only with exact=False), drop the last
    (worst) candidate instead, preserving order.
    """
    m, kp1 = ids.shape
    self_ids = (np.arange(m) + row_offset)[:, None]
    is_self = ids == self_ids
    # Position to drop: the self id where found, else the final column.
    drop = np.where(is_self.any(axis=1), is_self.argmax(axis=1), kp1 - 1)
    keep = np.arange(kp1)[None, :] != drop[:, None]
    return ids[keep].reshape(m, kp1 - 1)


# Connectivity runs on the host with vectorized numpy BFS: level-synchronous
# BFS is O(E) and finishes in milliseconds to seconds at 1M, while a device
# formulation (label propagation by scatter) has millions of duplicate
# indices. The device does the O(n^2 d) distance math, the host the O(E)
# bookkeeping.


def _reverse_csr(graph: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """CSR of incoming edges: in-neighbors of v are rsrc[indptr[v]:indptr[v+1]].

    Sorted via a packed (dst << bits_e) | edge_index key through np.sort
    (radix for ints): one O(E) pass replaces the stable argsort PLUS the
    32M-element src[order] gather — measured ~3x faster at 1M x K=32,
    the dominant term of the build's host tail. In-neighbor order within
    a node (ascending source id) matches the old stable argsort exactly.
    Falls back to argsort when n*E overflows the 63-bit key (>= ~10^9
    edges, beyond host-memory scale anyway).
    """
    n, K = graph.shape
    bits = max(1, n - 1).bit_length()
    if 2 * bits <= 63:
        # (dst << bits) | src: radix np.sort of one packed key. Invalid
        # edges (dst < 0) pack negative and are dropped by one compare.
        # Ties (same dst, same src — duplicate edges) are order-free, so
        # packing src instead of the edge index loses nothing.
        packed = ((graph.astype(np.int64) << bits)
                  | np.arange(n, dtype=np.int64)[:, None]).ravel()
        packed = packed[packed >= 0]
        packed.sort()
        rsrc = (packed & ((1 << bits) - 1)).astype(np.int32)
        dst = packed >> bits
    else:  # pragma: no cover - n >= 2^31: beyond host-memory scale
        flat = graph.ravel()
        valid_e = np.nonzero(flat >= 0)[0]
        dst = flat[valid_e].astype(np.int64)
        order = np.argsort(dst, kind="stable")
        rsrc = (valid_e[order] // K).astype(np.int32)
        dst = dst[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    return indptr, rsrc


def _gather_csr(indptr: np.ndarray, data: np.ndarray,
                nodes: np.ndarray) -> np.ndarray:
    """Concatenate data[indptr[v]:indptr[v+1]] for all v in nodes (vectorized)."""
    counts = (indptr[nodes + 1] - indptr[nodes]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=data.dtype)
    starts = indptr[nodes]
    # index trick: offsets within each run + repeated starts
    run_ids = np.repeat(np.arange(len(nodes)), counts)
    offsets = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    return data[starts[run_ids] + offsets]


def forward_reachable(graph, entry_ids) -> np.ndarray:
    """Boolean mask: directed-reachable from ``entry_ids`` (the walker's
    reachability guarantee checked by ``ensure_connected``)."""
    graph = np.asarray(graph)
    n = graph.shape[0]
    reached = np.zeros(n, dtype=bool)
    frontier = np.unique(np.asarray(entry_ids))
    frontier = frontier[(frontier >= 0) & (frontier < n)]
    reached[frontier] = True
    while frontier.size:
        nxt = graph[frontier].ravel()
        nxt = nxt[nxt >= 0]
        nxt = np.unique(nxt)
        nxt = nxt[~reached[nxt]]
        reached[nxt] = True
        frontier = nxt
    return reached


def connected_components(graph) -> np.ndarray:
    """Component label per node (weak connectivity), as int32 (n,).
    Level-synchronous BFS over forward + reverse edges; O(E) total."""
    graph = np.asarray(graph)
    n = graph.shape[0]
    indptr, rsrc = _reverse_csr(graph)
    labels = np.full(n, -1, dtype=np.int32)
    comp = 0
    for seed in range(n):
        if labels[seed] >= 0:
            continue
        labels[seed] = comp
        frontier = np.array([seed], dtype=np.int64)
        while frontier.size:
            fwd = graph[frontier].ravel()
            fwd = fwd[fwd >= 0]
            rev = _gather_csr(indptr, rsrc, frontier)
            nxt = np.unique(np.concatenate([fwd, rev.astype(np.int64)]))
            nxt = nxt[labels[nxt] < 0]
            labels[nxt] = comp
            frontier = nxt
        comp += 1
    return labels


def ensure_connected(base, graph: np.ndarray, *, metric: str = "l2",
                     entry_ids: np.ndarray | None = None,
                     max_rounds: int = 64, verbose: bool = False) -> np.ndarray:
    """Make every node *directed-reachable from the walker's entry points*
    by splicing bridge edges in place of worst kNN edges.

    An exact kNN graph on clustered data fragments into one component per
    cluster, which caps the recall any graph walker can reach (measured:
    4.9%-reachable graph → R@1 plateau ~0.84 on the synthetic SIFT
    stand-in). Weak connectivity is not enough — the walker follows edges
    forward, so the guarantee must be directed reachability from the entry
    set (measured: weak-only bridging still left a 0.90 recall plateau on
    256-node shards). The reference sidesteps all this because SIFT/GIST kNN
    graphs are naturally near-connected; a general engine must not rely on
    that.

    Each round: host-BFS forward reachability from the entries;
    weak-component labels restricted to the unreached set; then for one
    representative per unreached component, the exact nearest *reached* node
    (one batched distance sweep) donates its worst adjacency slot to a
    bridge edge into the component (plus the reverse edge for navigability).
    Index memory is unchanged — degree stays K.
    """
    from gbnns_tpu_torch.search.walker import default_entry_ids

    graph = np.array(graph, dtype=np.int32, copy=True)
    n, K = graph.shape
    if entry_ids is None:
        entry_ids = np.asarray(default_entry_ids(n))

    # Slot accounting: each node may donate up to 2 of its worst adjacency
    # slots to bridges (slot K-1, then K-2). A node that already donated
    # must still be allowed to RECEIVE a bridge later — treating "used"
    # as binary deadlocked repair with a few permanently-unreached nodes.
    donated: dict[int, int] = {}
    MAX_DONATE = 2

    def can_donate(node: int) -> bool:
        return donated.get(node, 0) < MAX_DONATE

    def bridge(src: int, rep: int) -> None:
        graph[src, K - 1 - donated.get(src, 0)] = rep
        donated[src] = donated.get(src, 0) + 1
        graph[rep, K - 1 - donated.get(rep, 0)] = src
        donated[rep] = donated.get(rep, 0) + 1

    for _ in range(max_rounds):
        reached = forward_reachable(graph, entry_ids)
        if reached.all():
            break
        # Weak components among unreached nodes only, computed on the
        # unreached-INDUCED subgraph (edges to reached nodes dropped, ids
        # remapped). Labeling the full graph with reached nodes masked to
        # self-loops is equivalent but was the build's biggest host cost:
        # every reached node is a singleton component, so the BFS seed
        # loop ran n (not U) Python iterations — 29 s at 1M with 5 nodes
        # unreached, vs microseconds on the subgraph.
        un = np.flatnonzero(~reached)
        remap = np.full(n, -1, dtype=np.int64)
        remap[un] = np.arange(un.size)
        sub = remap[np.maximum(graph[un], 0)]
        sub = np.where(graph[un] >= 0, sub, -1)
        self_col_u = np.arange(un.size, dtype=np.int64)[:, None]
        sub = np.where(sub >= 0, sub, self_col_u).astype(np.int32)
        labels_sub = connected_components(sub)
        # Representatives: one per unreached weak component, PLUS every
        # unreached node with no incoming edge at all — such nodes can never
        # become reachable except through a bridge, so deferring them only
        # adds rounds (measured: collapses ~25 rounds to ~3 at n=100k).
        uniq_labels, first_members = np.unique(labels_sub, return_index=True)
        comp_reps = un[first_members]
        indeg = np.bincount(graph[graph >= 0].ravel(), minlength=n)
        orphan_reps = np.flatnonzero((indeg == 0) & ~reached)
        reps = np.unique(np.concatenate([comp_reps, orphan_reps]))
        if verbose:
            print(f"  ensure_connected: {len(comp_reps)} components, "
                  f"{len(orphan_reps)} orphans ({(~reached).sum()} nodes "
                  f"unreached)", flush=True)
        # Cheap path first: a rep's own kNN row already lists its nearest
        # nodes — if any of them is reached (and unused), it is a
        # near-optimal bridge source at zero distance-computation cost.
        # Only reps whose whole adjacency is unreached (deep inside an
        # unreached cluster) fall through to the exact scoring below.
        # At n=1M with ~1e5 zero-in-degree orphans this shortcut removes
        # minutes of host sgemm per round.
        remaining = []
        for rep in reps:
            if not can_donate(int(rep)):
                remaining.append(rep)
                continue
            src = -1
            for cand in graph[rep]:
                ci = int(cand)
                if ci >= 0 and ci != rep and reached[ci] and can_donate(ci):
                    src = ci
                    break
            if src < 0:
                remaining.append(rep)
                continue
            bridge(src, int(rep))
        reps = np.asarray(remaining, dtype=np.int64)
        # Exact scoring for the remainder: host BLAS over thin (C, n)
        # distance rows, chunked over reps to bound memory.
        base_v = np.asarray(base, dtype=np.float32)
        base_sq = np.sum(base_v * base_v, axis=-1)
        invalid_cols = ~reached

        def saturated_arr():
            sat = [k_ for k_, v in donated.items() if v >= MAX_DONATE]
            return np.asarray(sat, dtype=np.int64) if sat else None

        used_arr = saturated_arr()
        for off in range(0, len(reps), 2048):
            rs = reps[off:off + 2048]
            rv = base_v[rs]
            if metric in ("ip", "angular"):
                d = -(rv @ base_v.T)
            else:
                d = (np.sum(rv * rv, -1)[:, None] - 2.0 * (rv @ base_v.T)
                     + base_sq[None, :])
            d[:, invalid_cols] = np.inf  # source must already be reachable
            if used_arr is not None and used_arr.size:
                d[:, used_arr] = np.inf
            sources = d.argmin(axis=1).astype(np.int32)
            # Collisions (two reps picking the same source this round) would
            # overwrite the same slot; keep the first, defer the rest.
            for i, (rep, src) in enumerate(zip(rs, sources)):
                if not (can_donate(int(src)) and can_donate(int(rep))
                        and np.isfinite(d[i, src]) and int(src) != int(rep)):
                    continue
                bridge(int(src), int(rep))
            used_arr = saturated_arr()
    return graph


def save_graph(path: str, graph: np.ndarray) -> None:
    """Persist the adjacency artifact, readable by either package."""
    np.save(path, np.ascontiguousarray(graph, dtype=np.int32))


def load_graph(path: str) -> np.ndarray:
    g = np.load(path, mmap_mode="r")
    if g.ndim != 2 or g.dtype != np.int32:
        raise ValueError(f"{path}: expected (n, K) int32 adjacency, got {g.shape} {g.dtype}")
    return g
