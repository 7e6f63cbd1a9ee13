"""gbnns_tpu_torch — the PyTorch and CUDA port of ``gbnns_tpu``: graph-based
nearest-neighbour search with learned dimensionality reduction, on an
NVIDIA H100.

The JAX package stays beside it as the reference; this package imports none
of it, nor JAX. Module names follow the JAX package's, so each module's
counterpart is found by name (``search/walker.py`` is ``walker_jax.py``,
``search/walker_payload.py`` is ``walker_pallas.py``,
``kernels/distance_topk.py`` is ``distance_topk_pallas.py``). Every module
of the JAX package is ported (ROADMAP.md lists what stays open), and every
Pallas kernel has its CUDA counterpart.

  io/        fvecs/ivecs codecs, dataset registry, synthetic data
  kernels/   distances, exact kNN (chunked, and the fused exact kNN), the
             binned and shifted-key scans, top-c merge, gated top-m scan
             and row gather (hand-written CUDA kernels under
             kernels/csrc/)
  build/     kNN-graph build and its host passes, k-means
  dimred/    projection models, PCA, the triplet trainer and checkpoints
  search/    re-rank, flat index, IVF index, cluster-gated scan index,
             centroid entries, beam walkers, graph index, sharded search
             over a mesh of devices, device-memory sizing
  eval/      recall, exact ground truth, QPS timing, tracing, plots
  config.py  experiment configuration; pipeline.py the experiment driver
  serve.py   HTTP search service; cli.py its command line
  native.py  ctypes binding of the C++ reference engine (native/)
  bench.py   the headline benchmark (python -m gbnns_tpu_torch.bench)

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
    "IVFIndex": "gbnns_tpu_torch.search.ivf",
    "CentroidEntries": "gbnns_tpu_torch.search.entries",
    "build_knn_graph": "gbnns_tpu_torch.build.knn_graph",
    "beam_search": "gbnns_tpu_torch.search.walker",
    "beam_search_payload": "gbnns_tpu_torch.search.walker_payload",
    "SearchService": "gbnns_tpu_torch.serve",
    "TrainConfig": "gbnns_tpu_torch.dimred.train",
    "train_projection": "gbnns_tpu_torch.dimred.train",
    "load_projection": "gbnns_tpu_torch.dimred.train",
    "project": "gbnns_tpu_torch.dimred.train",
    "pca_fit": "gbnns_tpu_torch.dimred.pca",
    "pca_transform": "gbnns_tpu_torch.dimred.pca",
    "load_dataset": "gbnns_tpu_torch.io.datasets",
    "exact_ground_truth": "gbnns_tpu_torch.eval.recall",
    "recall_at_k": "gbnns_tpu_torch.eval.recall",
    "resolve_device": "gbnns_tpu_torch._device",
    # sharded search (one process drives every shard's device)
    "make_mesh": "gbnns_tpu_torch.search.sharded",
    "build_sharded_index": "gbnns_tpu_torch.search.sharded",
    "sharded_search": "gbnns_tpu_torch.search.sharded",
    # experiment driver
    "ExperimentConfig": "gbnns_tpu_torch.config",
    "run_pipeline": "gbnns_tpu_torch.pipeline",
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
