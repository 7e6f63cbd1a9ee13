"""gbnns_tpu_torch — the PyTorch and CUDA port of ``gbnns_tpu``: graph-based
nearest-neighbour search with learned dimensionality reduction, on an
NVIDIA H100.

The JAX package stays beside it as the reference; this package imports none
of it, nor JAX. Module names follow the JAX package's, so each module's
counterpart is found by name (``search/walker.py`` is ``walker_jax.py``,
``search/walker_payload.py`` is ``walker_pallas.py``,
``kernels/distance_topk.py`` is ``distance_topk_pallas.py``). Ported so far
(ROADMAP.md): the fused-scan serving path (binned and shifted), the graph
serving path, the cluster-gated scan and the exact fused kNN; every Pallas
kernel of the JAX package has its CUDA counterpart.

  io/        fvecs/ivecs codecs, dataset registry, synthetic data
  kernels/   distances, exact kNN (chunked, and the fused exact kNN), the
             binned and shifted-key scans, top-c merge, gated top-m scan
             and row gather (hand-written CUDA kernels under
             kernels/csrc/)
  build/     kNN-graph build and its host passes, k-means
  dimred/    projection models and the checkpoint loader
  search/    re-rank, flat index, cluster-gated scan index, centroid
             entries, beam walkers, graph index, device-memory sizing
  eval/      recall, exact ground truth
  serve.py   HTTP search service; cli.py its command line

Entry points take ``device=None``, which means the card: without a CUDA
device they raise unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

# Lazy top-level API: importing the package loads no submodule.
_EXPORTS = {
    "FusedScanIndex": "gbnns_tpu_torch.kernels.scan_topk",
    "FlatIndex": "gbnns_tpu_torch.search.flat",
    "GraphIndex": "gbnns_tpu_torch.search.graph_index",
    "GatedScanIndex": "gbnns_tpu_torch.search.gated",
    "CentroidEntries": "gbnns_tpu_torch.search.entries",
    "build_knn_graph": "gbnns_tpu_torch.build.knn_graph",
    "beam_search": "gbnns_tpu_torch.search.walker",
    "beam_search_payload": "gbnns_tpu_torch.search.walker_payload",
    "SearchService": "gbnns_tpu_torch.serve",
    "load_projection": "gbnns_tpu_torch.dimred.train",
    "project": "gbnns_tpu_torch.dimred.train",
    "load_dataset": "gbnns_tpu_torch.io.datasets",
    "exact_ground_truth": "gbnns_tpu_torch.eval.recall",
    "recall_at_k": "gbnns_tpu_torch.eval.recall",
    "resolve_device": "gbnns_tpu_torch._device",
}

__all__ = ["__version__", *_EXPORTS]


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'gbnns_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(__all__)
