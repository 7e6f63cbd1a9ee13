"""End-to-end experiment pipeline: dataset → GT → projection → graph →
search sweep → results.

Port of ``gbnns_tpu/pipeline.py``, with the same staged artifacts: each
stage's output is written to ``cfg.out_dir`` (the results JSON, the recall
plot, the trained projection), and the stages are functions a caller can
mix. Every stage that computes takes ``device`` (None: the card; without
one the call raises unless the caller passes ``device="cpu"``).

The trained projection is cached as ``proj_<name>_<key>.npz`` under the
key the JAX package computes (a hash of the same ``repr``), in its
checkpoint layout, so either package loads the other's file instead of
training again.

Graph space: ``graph.space="full"`` builds the kNN graph on the
full-dimension vectors (true neighbourhoods), ``"reduced"`` in the walk's
projected geometry; the walk measures the reduced space and the final pool
is re-ranked at full dimension.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.config import ExperimentConfig


def prepare_data(cfg: ExperimentConfig):
    from gbnns_tpu_torch.io.datasets import load_dataset

    return load_dataset(cfg.dataset, scale=cfg.scale, max_base=cfg.max_base,
                        seed=cfg.seed)


def compute_gt(cfg: ExperimentConfig, base, query, k: int = 100, *,
               device=None):
    from gbnns_tpu_torch.eval.recall import exact_ground_truth

    return exact_ground_truth(query, base, k=min(k, base.shape[0]),
                              metric=cfg.metric, device=device)


def fit_projection(cfg: ExperimentConfig, base, query, gt, *, device=None):
    """Returns (base_lo, query_lo, artifact_dict)."""
    m = cfg.dimred.method
    if m == "none":
        return base, query, {}
    if m == "pca":
        from gbnns_tpu_torch.dimred.pca import pca_fit, pca_transform

        model = pca_fit(base, cfg.dimred.d_out, device=device)
        normalize = cfg.metric == "angular"
        return (pca_transform(model, base, normalize=normalize, device=device),
                pca_transform(model, query, normalize=normalize,
                              device=device),
                {"pca_mean": model.mean, "pca_components": model.components})
    from gbnns_tpu_torch.dimred.train import (TrainConfig, load_projection,
                                              project, save_projection,
                                              train_projection)

    tc = TrainConfig(d_out=cfg.dimred.d_out, model=m, hidden=cfg.dimred.hidden,
                     metric=cfg.metric, margin=cfg.dimred.margin,
                     lr=cfg.dimred.lr, batch_size=cfg.dimred.batch_size,
                     steps=cfg.dimred.steps, k_pos=cfg.dimred.k_pos,
                     hard_negatives=cfg.dimred.hard_negatives,
                     neg_ranks=cfg.dimred.neg_ranks,
                     eval_every=cfg.dimred.eval_every,
                     seed=cfg.dimred.seed)
    # staged projection, keyed on everything that shapes training (the
    # dataset identity, the whole TrainConfig, the supervision sample): a
    # rerun with an unchanged config loads instead of training. Delete the
    # npz (or change any knob) to train again.
    import hashlib

    key_src = repr((cfg.dataset, cfg.scale, cfg.max_base, cfg.metric,
                    cfg.seed, cfg.dimred.train_sample, dataclasses_repr(tc),
                    int(base.shape[0]), int(base.shape[1])))
    key = hashlib.sha256(key_src.encode()).hexdigest()[:16]
    os.makedirs(cfg.out_dir, exist_ok=True)
    cache = os.path.join(cfg.out_dir, f"proj_{cfg.name}_{key}.npz")
    trained = None
    if os.path.exists(cache):
        try:
            trained = load_projection(cache, device=device)
            print(f"  projection cache hit: {os.path.basename(cache)}",
                  flush=True)
        except (OSError, ValueError, KeyError) as e:
            print(f"  projection cache unreadable ({e}); retraining",
                  flush=True)
    if trained is None:
        base_train, nbrs = gt_for_training(cfg, base, gt, device=device)
        trained = train_projection(base_train, nbrs, tc, device=device)
        save_projection(cache, trained)
    return project(trained, base), project(trained, query), {"trained": trained}


def dataclasses_repr(tc) -> str:
    import dataclasses as _dc

    return repr(_dc.asdict(tc))


def gt_for_training(cfg: ExperimentConfig, base, gt_query, *, device=None):
    """Training supervision: ``(base_train, nbrs)``, each training row's
    true near neighbours as in-sample indices, widened past k_pos when
    rank-band negatives (``dimred.neg_ranks``) need deeper ranks. The exact
    base-vs-base GT is O(n²), so the supervision set is capped at
    ``dimred.train_sample`` rows, drawn by ``default_rng(dimred.seed)``."""
    from gbnns_tpu_torch.eval.recall import exact_ground_truth

    need = cfg.dimred.k_pos
    if cfg.dimred.neg_ranks is not None:
        need = max(need, cfg.dimred.neg_ranks[1])
    n = base.shape[0]
    cap = cfg.dimred.train_sample
    base_train = base
    if cap and 0 < cap < n:
        rng = np.random.default_rng(cfg.dimred.seed)
        base_train = base[rng.choice(n, size=cap, replace=False)]
    nbrs = exact_ground_truth(base_train, base_train, k=need + 1,
                              metric=cfg.metric, device=device)
    return base_train, nbrs[:, 1:]


def build_graph(cfg: ExperimentConfig, base, base_lo=None, *, device=None):
    """Build the kNN graph over ``cfg.graph.space`` vectors: "full" or
    "reduced" (see ``GraphConfig.space``). Returns (graph, seconds)."""
    from gbnns_tpu_torch.build.knn_graph import build_knn_graph

    g = cfg.graph
    if g.space not in ("full", "reduced"):
        raise ValueError(f"unknown graph space {g.space!r}")
    vectors = base
    if g.space == "reduced":
        if base_lo is None:
            raise ValueError("graph.space='reduced' needs a projection "
                             "(dimred.method != 'none')")
        vectors = base_lo
    t0 = time.perf_counter()
    graph = build_knn_graph(vectors, g.k, metric=cfg.metric, chunk=g.chunk,
                            node_chunk=g.node_chunk, exact=g.exact,
                            recall_target=g.recall_target,
                            precision=g.precision, connect=g.connect,
                            backend=g.backend, device=device)
    return graph, time.perf_counter() - t0


def run_pipeline(cfg: ExperimentConfig, *, device=None) -> dict[str, Any]:
    """Every stage in turn; writes ``<out_dir>/<name>.json`` (and the
    plot). Returns the summary, the graph (or None), the projection's
    artifacts, the JSON's path, the dataset's ``source`` and each stage's
    seconds (``stage_s``: data, gt, projection, graph, search), which it
    also prints."""
    from gbnns_tpu_torch.cli import _run_search
    from gbnns_tpu_torch.eval.bench import pareto, sweep

    stage_s = {}
    t0 = time.perf_counter()

    def stage(name):
        nonlocal t0
        stage_s[name] = time.perf_counter() - t0
        print(f"  stage {name}: {stage_s[name]:.2f} s", flush=True)
        t0 = time.perf_counter()

    os.makedirs(cfg.out_dir, exist_ok=True)
    ds = prepare_data(cfg)
    base, query = ds.base, ds.query
    stage("data")
    gt = (ds.gt if ds.gt is not None
          else compute_gt(cfg, base, query, device=device))
    stage("gt")
    base_lo, query_lo, artifacts = fit_projection(cfg, base, query, gt,
                                                  device=device)
    stage("projection")
    # the sharded path builds its own per-shard subgraphs and the scans
    # need none, so the full-corpus graph is only built for the one-device
    # graph engine
    sharded = bool(cfg.n_devices and cfg.n_devices > 1)
    needs_graph = cfg.search.index == "graph" and not sharded
    graph, build_time = (build_graph(cfg, base, base_lo, device=device)
                         if needs_graph else (None, 0.0))
    stage("graph")

    if cfg.search.index in ("ivf", "gated"):
        efs = list(cfg.search.efs)  # probes need not cover k (rerank_c does)
    else:
        efs = [e for e in cfg.search.efs if e >= cfg.search.k]
        skipped = [e for e in cfg.search.efs if e < cfg.search.k]
        if skipped:
            print(f"  skipping ef<{cfg.search.k} (pool must cover top-k): "
                  f"{skipped}", flush=True)
    cfg.search.efs = tuple(efs)
    if sharded:
        results = _sharded_sweep(cfg, base, base_lo, query, query_lo, gt,
                                 device=device)
    elif cfg.search.index in ("flat", "fused", "ivf", "gated"):
        results = _flat_sweep(cfg, base, base_lo, query, query_lo, gt,
                              device=device)
    else:
        def run_one(ef):
            r, _ = _run_search(base, base_lo, query, query_lo, graph, gt, ef,
                               cfg.search.k, cfg.metric,
                               cfg.search.num_entries, cfg.search.max_hops,
                               cfg.search.visited_mode,
                               expand=cfg.search.expand,
                               dtype=cfg.search.dtype,
                               batch_size=cfg.search.batch_size,
                               packed=cfg.search.packed,
                               walker=cfg.search.walker,
                               centroid_entries=cfg.search.centroid_entries,
                               device=device)
            return r
        results = sweep(run_one, list(cfg.search.efs))
    stage("search")

    front = pareto(results)
    summary = {
        "name": cfg.name,
        "dataset": cfg.dataset,
        "n_base": int(base.shape[0]),
        "dim": int(base.shape[1]),
        "d_out": (None if cfg.dimred.method == "none" else cfg.dimred.d_out),
        "method": cfg.dimred.method,
        "graph_k": cfg.graph.k,
        "build_time_s": build_time,
        "results": [r.to_json() for r in results],
        "pareto": [r.to_json() for r in front],
    }
    out_path = os.path.join(cfg.out_dir, f"{cfg.name}.json")
    with open(out_path, "w") as f:
        # strict JSON: BenchResult.to_json() nulls non-finite floats, and
        # anything that slips through fails the write
        json.dump(summary, f, indent=2, allow_nan=False)
    try:  # the recall plot is optional: matplotlib may be missing
        from gbnns_tpu_torch.eval.plot import plot_sweeps

        png = os.path.join(cfg.out_dir, f"{cfg.name}.png")
        plot_sweeps({cfg.name: summary["results"]}, png,
                    title=f"{cfg.dataset}: recall vs QPS")
        summary["plot"] = png
    except Exception:  # noqa: BLE001 - a missing plot fails nothing
        pass
    return {"summary": summary, "graph": graph, "artifacts": artifacts,
            "out_path": out_path, "source": ds.source, "stage_s": stage_s}


def microbatch(fn, query_arrays, batch_size: int):
    """Run ``fn(*chunks)`` over micro-batches of the query tensors and
    concatenate the (ids, dists) outputs, which bounds device memory for
    large query sets
    (``SearchConfig.batch_size``). The tail chunk is padded to
    ``batch_size`` so every call sees one shape; the padding rows are
    dropped on the way out. ``batch_size <= 0`` or >= nq runs the whole set
    in one batch."""
    nq = query_arrays[0].shape[0]
    if not batch_size or batch_size >= nq:
        return fn(*query_arrays)
    ids_out, dists_out = [], []
    for s in range(0, nq, batch_size):
        e = min(s + batch_size, nq)
        chunk = [a[s:e] for a in query_arrays]
        if e - s < batch_size:   # the last row repeated
            chunk = [torch.cat([c, c[-1:].expand(batch_size - (e - s),
                                                 *c.shape[1:])])
                     for c in chunk]
        ids, dists = fn(*chunk)
        ids_out.append(ids[:e - s])
        dists_out.append(dists[:e - s])
    return torch.cat(ids_out), torch.cat(dists_out)


def _flat_sweep(cfg: ExperimentConfig, base, base_lo, query, query_lo, gt, *,
                device=None):
    """Sweep a scan engine (flat, fused, ivf, gated) over its recall knob:
    the re-rank pool c for the scans, probes for ivf and gated."""
    from gbnns_tpu_torch.eval.bench import TIMING_MODE, BenchResult, time_search
    from gbnns_tpu_torch.eval.recall import recall_at_k

    kind = cfg.search.index
    if kind == "fused":
        from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex

        sdt = "int8" if cfg.search.scan_dtype == "int8" else "bfloat16"
        idx = FusedScanIndex(base, base_lo, metric=cfg.metric, scan_dtype=sdt,
                             device=device)
    elif kind == "gated":
        from gbnns_tpu_torch.search.gated import GatedScanIndex

        idx = GatedScanIndex(base, base_lo, metric=cfg.metric,
                             ncent=cfg.search.ivf_ncent or None,
                             seed=cfg.seed, device=device)
    elif kind == "ivf":
        from gbnns_tpu_torch.search.ivf import IVFIndex

        idx = IVFIndex.build(base, base_lo, metric=cfg.metric,
                             ncent=cfg.search.ivf_ncent or None,
                             seed=cfg.seed, device=device)
    else:
        from gbnns_tpu_torch.search.flat import FlatIndex

        idx = FlatIndex(base, base_lo, metric=cfg.metric, device=device)
    dev = resolve_device(device)
    qf = torch.from_numpy(np.ascontiguousarray(query, np.float32)).to(dev)
    ql = (qf if query_lo is None else torch.from_numpy(
        np.ascontiguousarray(query_lo, np.float32)).to(dev))
    recall_k = min(10, cfg.search.k)
    results = []
    for c in cfg.search.efs:
        # distances a query (the reference's metric): scans evaluate every
        # reduced corpus row plus the full-dim re-rank pool; ivf and gated
        # their kept subsets plus the re-rank
        if kind == "ivf":
            dist_comps = float(c * idx.stats["cap"] + idx.stats["spill"]
                               + cfg.search.rerank_c)
            kw = dict(probes=c, c=cfg.search.rerank_c)
        elif kind == "gated":
            kw = dict(probes=c, c=cfg.search.rerank_c)
            # from the kept-cell share of the first batch; batch_size 0 is
            # the whole set (JAX's min(0, nq) plans an empty batch and
            # divides by zero)
            bs = min(cfg.search.batch_size or query.shape[0], query.shape[0])
            _, _, kept = idx.search(qf[:bs], ql[:bs], k=cfg.search.k,
                                    return_kept_frac=True, **kw)
            n_pad = idx.stats["n_chunks"] * idx.chunk
            dist_comps = float(kept * n_pad + cfg.search.rerank_c)
        else:
            dist_comps = float(base.shape[0] + c)
            kw = dict(c=c)

        def run(kw=kw):
            return microbatch(
                lambda q, qlo: idx.search(q, qlo, k=cfg.search.k, **kw),
                (qf, ql), cfg.search.batch_size)
        qps, sec, (ids, dists) = time_search(run, query.shape[0],
                                             warmup=1, iters=3)
        ids = ids.cpu().numpy()
        r = BenchResult(
            label=f"{kind}-c{c}", ef=c, qps=qps, latency_ms=sec * 1e3,
            recall_at_1=recall_at_k(ids, gt, 1),
            recall_at_10=recall_at_k(ids, gt, recall_k),
            n_queries=query.shape[0],
            dist_comps_per_query=dist_comps,
            hops=0, extra={"index": kind, "recall_cutoff": recall_k,
                           "timing": TIMING_MODE})
        results.append(r)
        print(f"  c={c:4d}  R@1={r.recall_at_1:.4f}  R@10={r.recall_at_10:.4f}"
              f"  QPS={r.qps:,.0f}", flush=True)
    return results


def _sharded_sweep(cfg: ExperimentConfig, base, base_lo, query, query_lo, gt,
                   *, device=None):
    """Sweep the sharded engine over ``cfg.n_devices`` shards: the first
    that many cards, or all on ``device`` when one is named."""
    from gbnns_tpu_torch.eval.bench import TIMING_MODE, BenchResult, time_search
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.search.sharded import (build_sharded_index,
                                                make_mesh, sharded_search)

    mesh = make_mesh(cfg.n_devices, device=device)
    idx = build_sharded_index(
        base, cfg.graph.k, mesh, base_lo=base_lo, metric=cfg.metric,
        with_graph=cfg.search.index in ("graph", "graph_pallas"),
        with_payload=cfg.search.index == "graph_pallas",
        ncent=(cfg.search.centroid_entries or 64
               if cfg.search.index == "graph_pallas" else 0),
        build_kwargs=dict(chunk=cfg.graph.chunk,
                          node_chunk=cfg.graph.node_chunk,
                          exact=cfg.graph.exact, connect=cfg.graph.connect))
    results = []
    for ef in cfg.search.efs:
        def run():
            return sharded_search(idx, query_lo, cfg.search.k, ef=ef,
                                  num_entries=cfg.search.num_entries,
                                  max_hops=cfg.search.max_hops,
                                  metric=cfg.metric,
                                  engine=cfg.search.index,
                                  queries_full=query)
        qps, sec, (ids, dists) = time_search(run, query_lo.shape[0],
                                             warmup=1, iters=3)
        ids = ids.cpu().numpy()
        recall_k = min(10, cfg.search.k)
        r = BenchResult(
            label=f"sharded-ef{ef}", ef=ef, qps=qps, latency_ms=sec * 1e3,
            recall_at_1=recall_at_k(ids, gt, 1),
            recall_at_10=recall_at_k(ids, gt, recall_k),
            n_queries=query_lo.shape[0],
            # scans: every reduced row once + each shard's full-dim re-rank
            # of ef candidates; graph walks: data-dependent (null)
            dist_comps_per_query=(
                float(base.shape[0] + cfg.n_devices * ef)
                if cfg.search.index in ("flat", "fused") else None),
            hops=-1, extra={"n_devices": cfg.n_devices,
                            "recall_cutoff": recall_k,
                            "timing": TIMING_MODE})
        results.append(r)
        print(f"  ef={ef:4d}  R@1={r.recall_at_1:.4f}  "
              f"R@10={r.recall_at_10:.4f}  QPS={r.qps:,.0f}", flush=True)
    return results
