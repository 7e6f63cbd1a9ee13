"""gbnns_tpu_torch — the PyTorch and CUDA port of ``gbnns_tpu``: graph-based
nearest-neighbour search with learned dimensionality reduction, on an
NVIDIA H100.

The JAX package stays beside it as the reference; this package imports none
of it, nor JAX. Module names follow the JAX package's, so each module's
counterpart is found by name. Ported so far (ROADMAP.md): the fused-scan
serving path.

  io/        fvecs/ivecs codecs, dataset registry, synthetic data
  kernels/   distances, exact kNN, the binned scan and top-c merge
             (hand-written CUDA kernels under kernels/csrc/)
  dimred/    projection models and the checkpoint loader
  search/    re-rank, flat index
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
