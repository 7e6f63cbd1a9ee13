"""Batched lockstep beam search over a kNN graph: the plain-torch walker.

Port of ``gbnns_tpu/search/walker_jax.py``. From its entries, each query's
walk expands the ``expand`` best unexpanded members of a pool of ``ef``
candidates per hop, scores their neighbours in the (reduced) search space,
and keeps the best ``ef``; it ends when every pool member is expanded. All B
queries advance in lockstep: a hop is a few batched ops (gather, batched
dot, compare, stable sorts). The JAX ``while_loop`` becomes a Python loop
that reads one flag from the device per hop to learn whether any walk is
still active: one host sync per hop.

Visited handling: ``"beam"`` (membership in the pool is the visited filter;
an evicted node may be scored again) or ``"exact"`` (a (B, n) byte table,
the reference's per-query visited set, for parity checks on small corpora).

Every sort is stable and carries its other operands by the sort's order, so
ties break toward the lower concatenation index, as in the JAX walker.
``walker_payload.beam_search_payload`` runs the same walk with the hop's
neighbour data fetched by kernel K3.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from gbnns_tpu_torch.kernels.distance import METRICS, exact_fp32, squared_norms

_INF = float("inf")


def default_entry_ids(n: int, num_entries: int = 32) -> torch.Tensor:
    """Strided sample of ``num_entries`` entry nodes, (E,) int32 on the CPU.
    A kNN graph is directed and may split into clusters, so spread-out
    entries seed the pool for reachability."""
    num_entries = min(num_entries, n)
    return (torch.arange(num_entries, dtype=torch.int32) * (n // num_entries)
            + (n // (2 * num_entries)))


@dataclasses.dataclass
class SearchResult:
    """Final candidate pool per query, ascending by search-space distance,
    plus work counters."""

    ids: torch.Tensor      # (B, ef) int32; -1 marks an unfilled slot
    dists: torch.Tensor    # (B, ef) float32 in the search space
    n_dist: torch.Tensor   # (B,) int32: distance computations performed
    hops: int              # lockstep hops executed


def _batched_dists(q, vecs, vec_sqnorms, q_sqnorms, metric: str):
    """Distances from ``q (B, d)`` to ``vecs (B, K, d)``: one batched fp32
    product (TF32 off)."""
    with exact_fp32():
        dots = torch.bmm(vecs, q[:, :, None])[..., 0]
    if metric in ("ip", "angular"):
        return -dots
    return torch.clamp(q_sqnorms[:, None] - 2.0 * dots + vec_sqnorms, min=0.0)


def select_frontier(beam_ids, expanded, M: int):
    """First M unexpanded entries of the distance-sorted pool: ``(f_ids
    (B, M) int32, 0-filled past the live count; live (B, M) bool; the new
    expanded mask)``. A rank cumsum and one stable sort of a 0/1 key."""
    unexp = ~expanded
    r = torch.cumsum(unexp.to(torch.int32), dim=1)
    pick = unexp & (r <= M)
    _, order = torch.sort((~pick).to(torch.int32), dim=1, stable=True)
    f_ids = torch.gather(beam_ids, 1, order[:, :M])
    npick = r[:, -1].clamp(max=M)
    live = (torch.arange(M, device=beam_ids.device)[None, :]
            < npick[:, None])
    return torch.where(live, f_ids, 0), live, expanded | pick


def merge_pool(beam_ids, beam_d, expanded, cand_ids, cand_d, cand_invalid,
               ef: int):
    """Pool ∪ candidates → the best ``ef``, distance-sorted: one stable sort
    of the distances, ids and expanded flags gathered by its order."""
    all_d = torch.cat([beam_d, cand_d], dim=1)
    d_s, order = torch.sort(all_d, dim=1, stable=True)
    order = order[:, :ef]
    ids = torch.gather(torch.cat([beam_ids, cand_ids], dim=1), 1, order)
    exp = torch.gather(torch.cat([expanded, cand_invalid], dim=1), 1, order)
    return ids, d_s[:, :ef], exp


def intra_dedup_mask(nbrs):
    """Repeats among the hop's own candidates ``(B, MK)``, the first
    occurrence kept: one stable sort by id, then the repeat flags scattered
    back to their positions."""
    id_s, order = torch.sort(nbrs, dim=1, stable=True)
    dup_s = torch.zeros_like(nbrs, dtype=torch.bool)
    dup_s[:, 1:] = id_s[:, 1:] == id_s[:, :-1]
    return torch.zeros_like(dup_s).scatter_(1, order, dup_s)


def pack_neighbors(graph, base, dtype=None):
    """Each node's neighbour vectors inlined next to its adjacency row:
    ``(packed_vecs (n, K, d), packed_sqnorms (n, K))`` as numpy arrays, for
    ``beam_search(packed_vecs=..., packed_sqnorms=...)``: one (K, d) row
    gather per expanded node instead of K."""
    graph = np.asarray(graph)
    packed = np.asarray(base)[graph]                   # (n, K, d)
    sq = (packed.astype(np.float32) ** 2).sum(-1)       # (n, K)
    if dtype is not None:
        packed = packed.astype(dtype)
    return packed, sq.astype(np.float32)


def _dedup(nbrs, dist, beam_ids, *, M: int, intra_dedup: bool,
           visited: torch.Tensor | None = None):
    """A hop's candidates that are no use: empty slots, nodes already in the
    pool, repeats among the M adjacency rows (the first kept) and, with a
    ``visited`` table, nodes scored before (the table is updated in place).
    Returns ``(invalid (B, MK) bool, dists with +inf where invalid)``."""
    dup = (nbrs[:, :, None] == beam_ids[:, None, :]).any(dim=-1)
    if M > 1 and intra_dedup:
        dup |= intra_dedup_mask(nbrs)
    if visited is not None:
        safe = nbrs.clamp(min=0).long()
        dup |= torch.gather(visited, 1, safe) > 0
        visited.scatter_reduce_(1, safe, (nbrs >= 0).to(torch.uint8), "amax")
    invalid = (nbrs < 0) | dup
    return invalid, torch.where(invalid, _INF, dist)


def _walk(qf: torch.Tensor, base_f32: torch.Tensor, entry_ids: torch.Tensor,
          fetch: Callable, *, n: int, ef: int, max_hops: int, metric: str,
          visited_mode: str, expand: int, intra_dedup: bool) -> SearchResult:
    """The lockstep walk shared by both walkers. ``fetch(f_ids, q_sq)``
    returns the frontier's neighbours and their distances, ``(nbrs (B, M*K)
    int32, dists (B, M*K) f32)``; slots of dead frontier entries become
    -1 here."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if visited_mode not in ("beam", "exact"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    B, d = qf.shape
    E = entry_ids.shape[-1]
    if E > ef:
        raise ValueError(f"entry count {E} > ef {ef}")
    M = max(1, min(expand, ef))
    q_sq = squared_norms(qf)

    # seed the pool with shared (E,) or per-query (B, E) entries
    e_ids = entry_ids.to(device=qf.device, dtype=torch.int32)
    if e_ids.ndim == 1:
        e_ids = e_ids[None, :].expand(B, E)
    e_vecs = base_f32[e_ids.long()]                          # (B, E, d)
    e_d = _batched_dists(qf, e_vecs, squared_norms(e_vecs), q_sq, metric)
    beam_ids = torch.nn.functional.pad(e_ids, (0, ef - E), value=-1)
    beam_d = torch.nn.functional.pad(e_d, (0, ef - E), value=_INF)
    beam_d, order = torch.sort(beam_d, dim=1, stable=True)
    beam_ids = torch.gather(beam_ids, 1, order)
    expanded = beam_ids < 0  # padding slots never become the frontier

    visited = None
    if visited_mode == "exact":
        # a byte table, updated by max: a -1 slot clamps to node 0 and must
        # not mark it
        visited = torch.zeros((B, n), dtype=torch.uint8, device=qf.device)
        visited.scatter_reduce_(1, beam_ids.clamp(min=0).long(),
                                (beam_ids >= 0).to(torch.uint8), "amax")

    n_dist = torch.full((B,), E, dtype=torch.int32, device=qf.device)
    hops = 0
    while hops < max_hops:
        f_ids, live, expanded = select_frontier(beam_ids, expanded, M)
        nbrs, dist = fetch(f_ids, q_sq)
        nbrs = torch.where(
            live.repeat_interleave(nbrs.shape[1] // M, dim=1), nbrs, -1)
        invalid, cand_d = _dedup(nbrs, dist, beam_ids, M=M,
                                 intra_dedup=intra_dedup, visited=visited)
        n_dist += (~invalid).sum(dim=1, dtype=torch.int32)
        beam_ids, beam_d, expanded = merge_pool(
            beam_ids, beam_d, expanded, nbrs, cand_d, invalid, ef)
        hops += 1
        if not bool((~expanded).any()):  # one host sync per hop
            break
    return SearchResult(ids=beam_ids, dists=beam_d, n_dist=n_dist, hops=hops)


@torch.no_grad()
def beam_search(queries, base, graph, entry_ids, *, ef: int,
                max_hops: int = 256, metric: str = "l2",
                visited_mode: str = "beam",
                base_sqnorms: torch.Tensor | None = None,
                precision: str = "highest",
                expand: int = 4, intra_dedup: bool = True,
                packed_vecs: torch.Tensor | None = None,
                packed_sqnorms: torch.Tensor | None = None) -> SearchResult:
    """Lockstep beam search of ``queries (B, d)`` over ``graph (n, K)`` with
    vectors ``base (n, d)`` (the search space), all tensors on one device.
    ``entry_ids`` are shared ``(E,)`` or per-query ``(B, E)`` start nodes,
    E <= ef. ``expand`` frontier nodes are expanded per hop (1 reproduces
    the reference's one-at-a-time order); ``intra_dedup`` drops repeats
    among their neighbours. Distances are fp32; neighbour norms come from
    ``base_sqnorms`` when given, else from the gathered vectors (the same
    ops as the payload walker, which keeps the two bit-identical).
    ``packed_vecs``/``packed_sqnorms`` (from ``pack_neighbors``) fetch a
    node's K neighbour vectors as one row. ``precision`` is the JAX
    keyword, accepted and changing no result: every precision computes the
    fp32 distances (``"highest"``)."""
    dev = base.device
    qf = torch.as_tensor(queries, device=dev).float()
    graph = torch.as_tensor(graph, device=dev).to(torch.int32)
    base_f32 = base.float()
    B = qf.shape[0]
    n, K = graph.shape
    M = max(1, min(expand, ef))

    def fetch(f_ids, q_sq):
        f = f_ids.long()
        nbrs = graph[f].reshape(B, M * K)
        safe = nbrs.clamp(min=0).long()
        if packed_vecs is not None:
            nv = packed_vecs[f].reshape(B, M * K, -1).float()
            nsq = packed_sqnorms[f].reshape(B, M * K)
        else:
            nv = base_f32[safe]                                  # (B, MK, d)
            nsq = (squared_norms(nv) if base_sqnorms is None
                   else base_sqnorms[safe])
        return nbrs, _batched_dists(qf, nv, nsq, q_sq, metric)

    return _walk(qf, base_f32, torch.as_tensor(entry_ids), fetch, n=n, ef=ef,
                 max_hops=max_hops, metric=metric, visited_mode=visited_mode,
                 expand=expand, intra_dedup=intra_dedup)
