"""Typed experiment configuration with JSON overrides.

Port of ``gbnns_tpu/config.py``: the same dataclasses with the same fields,
defaults and field order, so every ``configs/*.json`` loads here to the same
``to_json()`` as there, and a config saved by either package loads in the
other. The experiment driver (``pipeline.run_pipeline``) and the CLI's
``pipeline`` subcommand read it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class GraphConfig:
    k: int = 32                    # graph degree K
    chunk: int = 65536             # base-sweep tile (columns of the distance matmul)
    node_chunk: int = 8192         # node tile (rows)
    exact: bool = True
    recall_target: float = 0.99    # JAX's approx_max_k target; selection is exact here
    connect: bool = True           # directed-reachability repair
    precision: str | None = None   # JAX's keyword; the sweep is full fp32 here
    # Distance-sweep backend (build.knn_graph): "xla" (the exact streaming
    # sweep) or "fused" (the binned scan K1 and top-c merge K2, the fast
    # approximate build); "pallas" raises, as in the JAX package.
    backend: str = "xla"
    # Which vectors the graph is built over. "full" encodes true
    # neighborhoods (reference behavior); "reduced" builds in the walk's own
    # projected geometry so every edge is locally greedy *in the space the
    # walk actually measures* — the fix for high-d configs where the
    # projection distorts full-dim neighborhoods enough that the walker
    # stalls.
    space: str = "full"            # "full" | "reduced"


@dataclasses.dataclass
class DimRedConfig:
    method: str = "none"           # "none" | "pca" | "linear" | "mlp"
    d_out: int = 32
    hidden: int = 512              # mlp only
    margin: float | None = None
    lr: float = 1e-3
    batch_size: int = 1024
    steps: int = 2000
    k_pos: int = 10
    hard_negatives: bool = True
    # Graph-mined negatives: (lo, hi) GT ranks to sample negatives from
    # (confusable near-misses), or null for uniform corpus negatives.
    neg_ranks: tuple[int, int] | None = None
    # Validation-gated checkpoint selection cadence (TrainConfig.eval_every):
    # score held-out NN-ordering preservation every N steps and keep the
    # best checkpoint INCLUDING the init (0 = off): the hinge recipe can
    # train below its own PCA init on Gaussian-like corpora.
    eval_every: int = 0
    # Training-positive subsample: the triplet trainer's positives come from
    # an exact in-sample GT, which is O(n²) on the full corpus. Projection
    # quality is bound by the corpus statistics, not by n (bench.py trains
    # on 262k rows), so cap the supervision set. 0 disables the cap.
    train_sample: int = 262_144
    seed: int = 0


@dataclasses.dataclass
class SearchConfig:
    # "graph" (beam walker) | "flat" (fp32 scan) | "fused" (binned scan,
    # kernels K1 and K2) | "ivf" (cluster-pruned scan) | "gated"
    # (cluster-gated scan, search/gated.py) | "graph_pallas" (sharded runs
    # only: per-shard payload walker, kernel K3)
    index: str = "graph"
    k: int = 10                    # final top-k
    efs: tuple[int, ...] = (16, 32, 64, 128, 256)  # recall knob sweep:
    # graph: pool size ef | flat/fused: re-rank pool c | ivf: probes
    rerank_c: int = 32             # ivf: re-rank pool (probes swept via efs)
    ivf_ncent: int = 0             # ivf: clusters (0 = auto ~4*sqrt(n))
    num_entries: int = 32
    max_hops: int = 256
    visited_mode: str = "beam"
    expand: int = 4                # frontier nodes expanded per lockstep hop
    dtype: str = "float32"         # search-space storage: float32 | bfloat16
    batch_size: int = 0            # 0 = whole query set in one device batch
    packed: bool = False           # walker: inline (K,d) neighbor rows (pack_neighbors)
    walker: str = "jax"            # graph hop: "jax" (plain gathers) | "pallas" (payload rows, K3)
    centroid_entries: int = 0      # >0: per-query k-means entry points (ncent)
    scan_dtype: str = "bfloat16"   # fused scan corpus: bfloat16 | int8
    # (int8: per-query dequantization; the re-rank absorbs the rounding)


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "experiment"
    dataset: str = "sift1m"
    scale: float = 1.0             # synthetic-fallback size multiplier
    max_base: int | None = None
    metric: str = "l2"
    seed: int = 0
    n_devices: int | None = None   # None = one device; >1 = sharded mesh
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    dimred: DimRedConfig = dataclasses.field(default_factory=DimRedConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    out_dir: str = "results"

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "ExperimentConfig":
        obj = dict(obj)
        graph = GraphConfig(**obj.pop("graph", {}))
        dimred_d = obj.pop("dimred", {})
        if dimred_d.get("neg_ranks") is not None:
            dimred_d["neg_ranks"] = tuple(dimred_d["neg_ranks"])
        dimred = DimRedConfig(**dimred_d)
        search_d = obj.pop("search", {})
        if "efs" in search_d:
            search_d["efs"] = tuple(search_d["efs"])
        search = SearchConfig(**search_d)
        return cls(graph=graph, dimred=dimred, search=search, **obj)

    @classmethod
    def load(cls, path: str, **overrides) -> "ExperimentConfig":
        with open(path) as f:
            obj = json.load(f)
        obj.update(overrides)
        return cls.from_json(obj)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
