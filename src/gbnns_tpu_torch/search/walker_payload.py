"""Lockstep beam search whose hop fetches one packed row per expanded node.

Counterpart of ``gbnns_tpu/search/walker_pallas.py`` (its name drops
"pallas": the port has none). Same search as ``walker.beam_search``; what
changes is the hop's fetch. For every expanded node a hop needs its
adjacency row and its K neighbour vectors, so each node's hop data is packed
into ONE row of a payload

    payload[v] = [ vecs of graph[v] (K x d, f32, or bf16 pairs in f32 words)
                   | graph[v] (K int32) | pad → a multiple of ROW_WORDS ]

and the hop fetches its rows with kernel K3 (``kernels.gather.row_gather``).
Rows are padded to 128 B (``search.sizing.ROW_WORDS``), not to the TPU's
4 KB tile: at K = 32, d = 32, bf16 a row is 544 words (2,176 B), and every
hop moves 47 % fewer bytes than at 4 KB. The hop's distances are batched
fp32 products on the decoded vectors, as the JAX walker computes them in
XLA outside its kernel; the bf16 payload decodes its pairs to bf16, rounds
the query to bf16 too, and accumulates in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import squared_norms
from gbnns_tpu_torch.kernels.gather import row_gather
from gbnns_tpu_torch.search.sizing import payload_row_words
from gbnns_tpu_torch.search.walker import SearchResult, _batched_dists, _walk


@dataclasses.dataclass(frozen=True)
class HopPayload:
    """Device-resident packed hop data: one row per node (module doc)."""

    data: torch.Tensor   # (n, words) f32 container
    n: int
    K: int
    d: int
    vec_words: int       # f32 words holding the K x d neighbour vectors
    bf16: bool

    @property
    def words(self) -> int:
        return self.data.shape[1]


@torch.no_grad()
def pack_hop_payload(graph, base_lo, *, vec_dtype: str = "float32",
                     node_chunk: int = 131072, device=None) -> HopPayload:
    """Pack adjacency + neighbour vectors into rows padded to a multiple of
    ``ROW_WORDS``, on the device. Norms are not stored: the hop recomputes
    them from the decoded vectors. Graph ids must lie in [-1, n); -1 (no
    edge) is never expanded by the walker."""
    dev = resolve_device(device)
    graph = np.asarray(graph, np.int32)
    base = np.asarray(base_lo, np.float32)
    n, K = graph.shape
    d = base.shape[1]
    if graph.size and (graph.min() < -1 or graph.max() >= base.shape[0]):
        raise ValueError(f"graph ids must lie in [-1, {base.shape[0]})")
    vec_words, words = payload_row_words(K, d, vec_dtype=vec_dtype)
    bf16 = vec_dtype == "bfloat16"
    g_all = torch.tensor(graph, device=dev)  # a copy: graph may be mmapped
    b = torch.from_numpy(base).to(dev)
    data = torch.zeros((n, words), dtype=torch.float32, device=dev)
    for lo in range(0, n, node_chunk):
        g = g_all[lo:lo + node_chunk]
        vecs = b[g.long()].reshape(g.shape[0], K * d)     # -1: the last row
        if bf16:  # little-endian pairs, as numpy's .view(np.float32)
            vecs = vecs.to(torch.bfloat16).view(torch.float32)
        data[lo:lo + node_chunk, :vec_words] = vecs
        data[lo:lo + node_chunk, vec_words:vec_words + K] = g.view(
            torch.float32)
    return HopPayload(data=data, n=n, K=K, d=d, vec_words=vec_words,
                      bf16=bf16)


def payload_from_jax(hp, *, device=None) -> HopPayload:
    """The port's payload from the JAX package's ``HopPayload``, its
    (n, S, 128) container re-rowed from 4 KB tiles to ``ROW_WORDS``."""
    words = payload_row_words(hp.K, hp.d,
                              vec_dtype="bfloat16" if hp.bf16 else "float32")[1]
    used = hp.vec_words + hp.K
    rows = np.asarray(hp.data, np.float32).reshape(hp.n, -1)[:, :used]
    data = np.zeros((hp.n, words), np.float32)
    data[:, :used] = rows
    return HopPayload(data=torch.from_numpy(data).to(resolve_device(device)),
                      n=hp.n, K=hp.K, d=hp.d, vec_words=hp.vec_words,
                      bf16=hp.bf16)


def _decode(raw, *, K: int, d: int, vec_words: int, bf16: bool):
    """Payload rows ``(R, words)`` → ``(vecs (R, K, d) f32, sq (R, K),
    ids (R, K) int32)``. A check of the layout; the hop uses
    ``_hop_dists``."""
    R = raw.shape[0]
    vw = raw[:, :vec_words].contiguous()
    if bf16:
        vw = vw.view(torch.bfloat16)
    vecs = vw.float().reshape(R, K, d)
    ids = raw[:, vec_words:vec_words + K].contiguous().view(torch.int32)
    return vecs, squared_norms(vecs), ids


def _hop_dists(raw, qf, q_sq, *, B: int, M: int, K: int, d: int,
               vec_words: int, bf16: bool, metric: str):
    """Distances and neighbour ids from the hop's gathered rows ``raw
    (B*M, words)``: ``(dist (B, M*K) f32, ids (B, M*K) int32)``."""
    ids = (raw[:, vec_words:vec_words + K].contiguous().view(torch.int32)
           .reshape(B, M * K))
    vw = raw[:, :vec_words].contiguous()
    if bf16:
        vecs = vw.view(torch.bfloat16).reshape(B, M * K, d).float()
        q = qf.to(torch.bfloat16).float()
    else:
        vecs = vw.reshape(B, M * K, d)
        q = qf
    return _batched_dists(q, vecs, squared_norms(vecs), q_sq, metric), ids


@torch.no_grad()
def beam_search_payload(queries, payload: HopPayload, base_lo, entry_ids, *,
                        ef: int, max_hops: int = 256, metric: str = "l2",
                        precision: str = "highest", expand: int = 4,
                        intra_dedup: bool = True, visited_mode: str = "beam",
                        interpret: bool | None = None,
                        gather: Callable = row_gather) -> SearchResult:
    """Payload-hop lockstep beam search: ``walker.beam_search`` with the
    same pool semantics and knobs; ``base_lo (n, d)`` only seeds the entry
    points. ``gather`` is the hop's row fetch: kernel K3 (``row_gather``)
    unless a check passes its plain version. With an f32 payload the walk
    is identical to ``beam_search``'s. ``precision`` and ``interpret`` are
    the JAX keywords, accepted and changing no result: the distances are
    fp32 at any precision, and there is no Pallas kernel to interpret."""
    data = payload.data
    qf = torch.as_tensor(queries, device=data.device).float()
    base_f32 = torch.as_tensor(base_lo, device=data.device).float()
    B = qf.shape[0]
    M = max(1, min(expand, ef))

    def fetch(f_ids, q_sq):
        # every frontier id is a pool member or 0, so the ids need no check
        raw = gather(data, f_ids.reshape(B * M), check_ids=False)
        dist, nbrs = _hop_dists(raw, qf, q_sq, B=B, M=M, K=payload.K,
                                d=payload.d, vec_words=payload.vec_words,
                                bf16=payload.bf16, metric=metric)
        return nbrs, dist

    return _walk(qf, base_f32, torch.as_tensor(entry_ids), fetch,
                 n=payload.n, ef=ef, max_hops=max_hops, metric=metric,
                 visited_mode=visited_mode, expand=expand,
                 intra_dedup=intra_dedup)


# The JAX package's name for the payload walker (``walker_pallas``), under
# which its callers import it.
beam_search_pallas = beam_search_payload
