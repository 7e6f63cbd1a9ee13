"""GraphIndex: the graph serving engine, assembled.

Port of ``gbnns_tpu/search/graph_index.py``: a kNN graph built in the
reduced space (``build.knn_graph``), the packed hop payload walked by
``walker_payload.beam_search_payload`` (kernel K3 on every hop), per-query
centroid entries (``entries.CentroidEntries``), and the exact full-dimension
re-rank shared with every other engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance import squared_norms
from gbnns_tpu_torch.search.entries import CentroidEntries, entries_from_jax
from gbnns_tpu_torch.search.rerank import rerank
from gbnns_tpu_torch.search.walker import default_entry_ids
from gbnns_tpu_torch.search.walker_payload import (HopPayload,
                                                   beam_search_payload,
                                                   pack_hop_payload,
                                                   payload_from_jax)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class GraphIndex:
    payload: HopPayload
    base_lo: torch.Tensor    # (n, d_lo) f32: entry seeding
    base_full: torch.Tensor  # (n, d) re-rank corpus
    base_sq: torch.Tensor    # (n,) f32
    graph: np.ndarray        # (n, K) int32, kept for artifacts and checks
    entries: CentroidEntries | None
    metric: str
    stats: dict

    @classmethod
    def build(cls, base_full, base_lo=None, *, K: int = 32,
              metric: str = "l2", vec_dtype: str = "bfloat16",
              ncent: int | None = 4096, seed: int = 0,
              graph: np.ndarray | None = None, rerank_dtype=torch.float32,
              entries: CentroidEntries | None = None,
              hbm_budget: float | None = None,
              build_kwargs: dict[str, Any] | None = None,
              device=None) -> "GraphIndex":
        """Build graph (reduced space) + payload + centroid entries.
        ``ncent=None`` (or 0) walks from strided entries instead; ``graph``
        reuses a built adjacency. ``rerank_dtype=bfloat16`` halves the
        re-rank corpus (its norms stay f32, taken before the cast).

        ``hbm_budget`` (bytes): raise ``MemoryError`` with the sizing
        breakdown (``search.sizing``) when the resident estimate exceeds
        it, before the graph build."""
        from gbnns_tpu_torch.build.knn_graph import build_knn_graph
        from gbnns_tpu_torch.search.sizing import graph_index_hbm

        dev = resolve_device(device)
        rerank_dtype = _DTYPES.get(rerank_dtype, rerank_dtype)
        base_full = np.asarray(base_full, np.float32)
        lo = base_full if base_lo is None else np.asarray(base_lo, np.float32)
        n, d_lo = lo.shape
        # raises on an odd K * d_lo for bf16 before the build, as the packer
        sz = graph_index_hbm(n, base_full.shape[1], d_lo, K,
                             vec_dtype=vec_dtype,
                             rerank_itemsize=rerank_dtype.itemsize)
        if hbm_budget is not None and sz.total_bytes > hbm_budget:
            raise MemoryError(
                f"GraphIndex resident estimate {sz.total_bytes / 1e9:.1f} GB "
                f"(payload {sz.payload_bytes / 1e9:.1f} + rerank corpus "
                f"{sz.rerank_bytes / 1e9:.1f} + reduced "
                f"{sz.reduced_bytes / 1e9:.1f}) exceeds budget "
                f"{hbm_budget / 1e9:.1f} GB; use rerank_dtype=bfloat16 or a "
                f"smaller K")
        if graph is None:
            graph = build_knn_graph(lo, K, metric=metric, device=dev,
                                    **(build_kwargs or {}))
        graph = np.asarray(graph, np.int32)
        payload = pack_hop_payload(graph, lo, vec_dtype=vec_dtype, device=dev)
        if entries is None and ncent:
            entries = CentroidEntries.build(lo, ncent=ncent, metric=metric,
                                            seed=seed, device=dev)
        bf = torch.from_numpy(base_full).to(dev)
        return cls(payload=payload, base_lo=torch.from_numpy(lo).to(dev),
                   base_full=bf.to(rerank_dtype), base_sq=squared_norms(bf),
                   graph=graph, entries=entries, metric=metric,
                   stats=dict(n=n, K=int(graph.shape[1]), vec_dtype=vec_dtype,
                              ncent=int(ncent or 0),
                              payload_bytes=payload.data.numel() * 4,
                              est_hbm_bytes=sz.total_bytes))

    @classmethod
    def from_jax(cls, gidx, *, device=None) -> "GraphIndex":
        """The port's index over the JAX package's ``GraphIndex``: the same
        graph, payload (re-rowed), entries and corpora, read through
        numpy."""
        dev = resolve_device(device)

        def put(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

        full = np.asarray(gidx.base_full)
        base_full = put(full)
        if full.dtype.name == "bfloat16":
            base_full = base_full.to(torch.bfloat16)
        payload = payload_from_jax(gidx.payload, device=dev)
        return cls(payload=payload, base_lo=put(gidx.base_lo),
                   base_full=base_full, base_sq=put(gidx.base_sq),
                   graph=np.asarray(gidx.graph, np.int32),
                   entries=(None if gidx.entries is None
                            else entries_from_jax(gidx.entries, device=dev)),
                   metric=gidx.metric,
                   stats={**gidx.stats,
                          "payload_bytes": payload.data.numel() * 4})

    def search(self, queries_full, queries_lo=None, *, k: int = 10,
               ef: int = 48, num_entries: int = 16, max_hops: int = 64,
               expand: int = 4):
        """Walk + exact re-rank: ``(ids (B, k) int32, dists (B, k) f32)``.
        ``ef`` (the candidate pool) is the recall knob."""
        dev = self.base_lo.device
        qf = torch.as_tensor(queries_full, dtype=torch.float32, device=dev)
        ql = qf if queries_lo is None else torch.as_tensor(
            queries_lo, dtype=torch.float32, device=dev)
        E = min(num_entries, ef)
        if self.entries is not None:
            ent = self.entries.query_entries(ql, E)
        else:
            ent = default_entry_ids(self.payload.n, E)
        res = beam_search_payload(ql, self.payload, self.base_lo, ent, ef=ef,
                                  metric=self.metric, max_hops=max_hops,
                                  expand=expand)
        return rerank(qf, self.base_full, res.ids, k, metric=self.metric,
                      base_sqnorms=self.base_sq)
