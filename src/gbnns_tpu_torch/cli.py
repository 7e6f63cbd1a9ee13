"""``python -m gbnns_tpu_torch.cli`` — the port's command line.

Port of the JAX package's ``gbnns`` CLI, with its subcommands over the same
file-staged artifacts (every stage reads its predecessors' outputs):

  synth     materialize a dataset as base.fvecs and query.fvecs
  gt        exact ground truth → ivecs
  build     kNN graph → npy (backends xla, fused)
  train     projection (pca | linear | mlp) → pca.npz or proj.npz, then
            base_lo.fvecs and query_lo.fvecs
  search    one search run at one ef → metrics JSON (and ids as ivecs)
  sweep     recall-vs-QPS curve over an ef sweep → results JSON
  plot      recall-vs-QPS curves from sweep JSONs → png
  serve     HTTP search service over staged artifacts (engines fused, flat,
            graph, graph_pallas)
  size      resident device-memory pre-check (one device or sharded)
  pipeline  all of the above from one config JSON

Each takes the JAX CLI's flags; those that compute also take ``--device``
(the card by default; ``cpu`` runs there). ``--n-devices N`` shards a
search over the first N cards, or over N shards of ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _load_base_query(args):
    from gbnns_tpu_torch.io.datasets import load_dataset
    from gbnns_tpu_torch.io.vecs import read_fvecs

    if getattr(args, "base", None):
        base = np.ascontiguousarray(read_fvecs(args.base), dtype=np.float32)
        query = (np.ascontiguousarray(read_fvecs(args.query), dtype=np.float32)
                 if getattr(args, "query", None) else None)
        return base, query
    ds = load_dataset(args.dataset, scale=args.scale, max_base=args.max_base)
    print(f"dataset {ds.info.name} [{ds.source}]: base {ds.base.shape}, "
          f"query {ds.query.shape}", flush=True)
    return ds.base, ds.query


def build_service(args):
    """The ``SearchService`` that ``serve`` runs, from parsed flags."""
    from gbnns_tpu_torch.build.knn_graph import load_graph
    from gbnns_tpu_torch.io.vecs import read_fvecs
    from gbnns_tpu_torch.serve import SearchService

    base, _ = _load_base_query(args)
    base_lo = (np.ascontiguousarray(read_fvecs(args.base_lo), dtype=np.float32)
               if args.base_lo else None)
    projection = None
    if args.proj:
        from gbnns_tpu_torch.dimred.train import load_projection, projector

        projection = projector(load_projection(args.proj, device=args.device))
    graph = np.asarray(load_graph(args.graph)) if args.graph else None
    return SearchService(base, base_lo, graph, metric=args.metric,
                         engine=args.engine, ef=args.ef, c=args.c,
                         projection=projection, scan_dtype=args.scan_dtype,
                         centroids_path=args.centroids,
                         h2d_dtype=args.h2d_dtype, device=args.device)


def cmd_synth(args):
    from gbnns_tpu_torch.io.datasets import load_dataset
    from gbnns_tpu_torch.io.vecs import write_fvecs

    ds = load_dataset(args.dataset, scale=args.scale, max_base=args.max_base)
    os.makedirs(args.out, exist_ok=True)
    write_fvecs(os.path.join(args.out, "base.fvecs"), ds.base)
    write_fvecs(os.path.join(args.out, "query.fvecs"), ds.query)
    print(f"wrote {args.out}/base.fvecs {ds.base.shape} and query.fvecs "
          f"{ds.query.shape}")


def cmd_gt(args):
    from gbnns_tpu_torch.eval.recall import exact_ground_truth
    from gbnns_tpu_torch.io.vecs import write_ivecs

    base, query = _load_base_query(args)
    t0 = time.perf_counter()
    gt = exact_ground_truth(query, base, k=args.k, metric=args.metric,
                            device=args.device)
    print(f"ground truth {gt.shape} in {time.perf_counter() - t0:.1f}s")
    write_ivecs(args.out, gt)
    print(f"wrote {args.out}")


def cmd_train(args):
    from gbnns_tpu_torch.dimred.pca import pca_fit, pca_transform
    from gbnns_tpu_torch.dimred.train import (TrainConfig, project,
                                              save_projection,
                                              train_projection)
    from gbnns_tpu_torch.eval.recall import exact_ground_truth
    from gbnns_tpu_torch.io.vecs import read_ivecs, write_fvecs

    base, query = _load_base_query(args)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    if args.method == "pca":
        model = pca_fit(base, args.d_out, device=args.device)
        angular = args.metric == "angular"
        base_lo = pca_transform(model, base, normalize=angular,
                                device=args.device)
        q_lo = (pca_transform(model, query, normalize=angular,
                              device=args.device)
                if query is not None else None)
        np.savez(os.path.join(args.out, "pca.npz"), mean=model.mean,
                 components=model.components)
    else:
        if args.neighbors:
            nbrs = np.asarray(read_ivecs(args.neighbors))
        else:
            print("computing training neighbors (exact GT of base vs base)...",
                  flush=True)
            nbrs = exact_ground_truth(base, base, k=args.k_pos + 1,
                                      device=args.device)[:, 1:]
        cfg = TrainConfig(d_out=args.d_out, model=args.method,
                          metric=args.metric, steps=args.steps,
                          batch_size=args.batch_size, lr=args.lr,
                          k_pos=args.k_pos, eval_every=args.eval_every,
                          seed=args.seed)
        trained = train_projection(base, nbrs, cfg,
                                   log_every=args.steps // 10 or 1,
                                   device=args.device)
        save_projection(os.path.join(args.out, "proj.npz"), trained)
        base_lo = project(trained, base)
        q_lo = project(trained, query) if query is not None else None
    print(f"trained {args.method} projection d→{args.d_out} in "
          f"{time.perf_counter() - t0:.1f}s")
    write_fvecs(os.path.join(args.out, "base_lo.fvecs"), base_lo)
    if q_lo is not None:
        write_fvecs(os.path.join(args.out, "query_lo.fvecs"), q_lo)
    print(f"wrote projected vectors to {args.out}/")


def cmd_build(args):
    from gbnns_tpu_torch.build.knn_graph import build_knn_graph, save_graph

    base, _ = _load_base_query(args)
    t0 = time.perf_counter()
    graph = build_knn_graph(base, args.k, metric=args.metric,
                            chunk=args.chunk, node_chunk=args.node_chunk,
                            exact=not args.approx, connect=not args.no_connect,
                            backend=args.backend, verbose=args.verbose,
                            device=args.device)
    dt = time.perf_counter() - t0
    save_graph(args.out, graph)
    print(f"built kNN graph {graph.shape} in {dt:.1f}s → {args.out}")


def _run_search(base_full, base_lo, query_full, query_lo, graph, gt, ef, k,
                metric, num_entries, max_hops, visited_mode, iters=3,
                expand=4, dtype="float32", batch_size=0, packed=False,
                walker="jax", centroid_entries=0, device=None):
    """One timed graph-walk run at ``ef`` plus the exact re-rank: a
    ``BenchResult`` and its ids. ``walker``: "jax" (``walker.beam_search``)
    or "pallas" (``walker_payload.beam_search_payload``, whose hop fetches
    packed rows with kernel K3); ``dtype`` is the search space's storage."""
    import torch

    from gbnns_tpu_torch._device import resolve_device
    from gbnns_tpu_torch.eval.bench import TIMING_MODE, BenchResult, time_search
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.pipeline import microbatch
    from gbnns_tpu_torch.search.rerank import rerank
    from gbnns_tpu_torch.search.walker import (beam_search, default_entry_ids,
                                               pack_neighbors)
    from gbnns_tpu_torch.search.walker_payload import (beam_search_payload,
                                                       pack_hop_payload)

    if walker not in ("jax", "pallas"):
        raise ValueError(f"unknown walker {walker!r}")
    if walker == "pallas" and visited_mode != "beam":
        raise ValueError("walker='pallas' supports visited_mode='beam' only "
                         "(the exact visited table is a parity/oracle mode "
                         "of the plain walker)")
    dev = resolve_device(device)
    sdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def put(a, dt=torch.float32):   # a copy: the arrays may be mmapped
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(dt)

    qlo, qfull = put(query_lo, sdt), put(query_full)
    blo, bfull = put(base_lo, sdt), put(base_full)
    bfull_sq = (bfull * bfull).sum(-1)
    gj = torch.tensor(np.asarray(graph, np.int32), device=dev)
    if centroid_entries > 0:
        from gbnns_tpu_torch.search.entries import CentroidEntries

        ce = CentroidEntries.build(base_lo, ncent=centroid_entries,
                                   metric=metric, device=dev)
        entries = ce.query_entries(put(query_lo), min(num_entries, ef))
    else:
        entries = default_entry_ids(base_lo.shape[0], min(num_entries, ef))
    pv = psq = payload = None
    if walker == "pallas":
        payload = pack_hop_payload(
            graph, base_lo, device=dev,
            vec_dtype="bfloat16" if dtype == "bfloat16" else "float32")
    elif packed:
        pv, psq = pack_neighbors(gj, put(base_lo))
        pv = pv.to(sdt)

    nq = query_lo.shape[0]
    n_dist_acc, hops_acc = [], []

    def search_chunk(qlo_c, qfull_c):
        if walker == "pallas":
            res = beam_search_payload(qlo_c.float(), payload, blo, entries,
                                      ef=ef, metric=metric,
                                      max_hops=max_hops, expand=expand)
        else:
            res = beam_search(qlo_c, blo, gj, entries, ef=ef, metric=metric,
                              max_hops=max_hops, visited_mode=visited_mode,
                              expand=expand, packed_vecs=pv,
                              packed_sqnorms=psq)
        n_dist_acc.append(res.n_dist)
        hops_acc.append(res.hops)
        return rerank(qfull_c, bfull, res.ids, k, metric=metric,
                      base_sqnorms=bfull_sq)

    def run():
        n_dist_acc.clear(), hops_acc.clear()
        return microbatch(search_chunk, (qlo, qfull), batch_size)

    qps, sec, (ids, _) = time_search(run, nq, warmup=1, iters=iters)
    ids = ids.cpu().numpy()
    n_dist = torch.cat([x.cpu() for x in n_dist_acc]).double()
    r1 = recall_at_k(ids, gt, 1) if gt is not None else float("nan")
    r10 = (recall_at_k(ids, gt, min(10, k)) if gt is not None
           else float("nan"))
    return BenchResult(
        label=f"ef{ef}", ef=ef, qps=qps, latency_ms=sec * 1e3,
        recall_at_1=r1, recall_at_10=r10, n_queries=nq,
        dist_comps_per_query=float(n_dist.mean()),
        hops=int(max(hops_acc)),
        extra={"recall_cutoff": min(10, k), "packed": packed,
               "walker": walker, "timing": TIMING_MODE}), ids


def _run_scan_engine(base, base_lo, query, q_lo, gt, ef, args):
    """One-device scan engines for ``search``/``sweep --engine flat|fused``:
    ``ef`` is the re-rank pool ``c`` (the scan's recall knob)."""
    import torch

    from gbnns_tpu_torch._device import resolve_device
    from gbnns_tpu_torch.eval.bench import TIMING_MODE, BenchResult, time_search
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.pipeline import microbatch

    if args.engine == "fused":
        from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex

        sdt = "int8" if args.scan_dtype == "int8" else "bfloat16"
        idx = FusedScanIndex(base, base_lo, metric=args.metric,
                             scan_dtype=sdt, device=args.device)
    else:
        from gbnns_tpu_torch.search.flat import FlatIndex

        idx = FlatIndex(base, base_lo, metric=args.metric,
                        device=args.device)
    c = max(ef, args.k)
    dev = resolve_device(args.device)
    qf = torch.from_numpy(np.ascontiguousarray(query, np.float32)).to(dev)
    ql = torch.from_numpy(np.ascontiguousarray(q_lo, np.float32)).to(dev)

    def run():
        return microbatch(lambda q, qlo: idx.search(q, qlo, k=args.k, c=c),
                          (qf, ql), args.batch_size)

    qps, sec, (ids, _) = time_search(run, query.shape[0], warmup=1, iters=3)
    ids = ids.cpu().numpy()
    r1 = recall_at_k(ids, gt, 1) if gt is not None else float("nan")
    r10 = (recall_at_k(ids, gt, min(10, args.k)) if gt is not None
           else float("nan"))
    return BenchResult(
        label=f"{args.engine}-c{c}", ef=c, qps=qps, latency_ms=sec * 1e3,
        recall_at_1=r1, recall_at_10=r10, n_queries=query.shape[0],
        dist_comps_per_query=float(base.shape[0] + c), hops=0,
        extra={"engine": args.engine, "scan_dtype": args.scan_dtype,
               "timing": TIMING_MODE}), ids


def _load_search_inputs(args):
    from gbnns_tpu_torch.build.knn_graph import load_graph
    from gbnns_tpu_torch.io.vecs import read_fvecs, read_ivecs

    base, query = _load_base_query(args)
    engine = getattr(args, "engine", "graph")
    # sharded runs build their own per-shard subgraphs: --graph is needed
    # there only when the sharded engine walks a graph
    if args.n_devices and args.n_devices > 1:
        needs_graph = getattr(args, "sharded_engine", "graph") in (
            "graph", "graph_pallas")
    else:
        needs_graph = engine in ("graph", "graph_pallas")
    if args.graph:
        graph = np.asarray(load_graph(args.graph))
        args.graph_k = graph.shape[1]  # the degree of sharded rebuilds
    elif needs_graph:
        raise SystemExit(f"--graph is required for engine={engine!r}")
    else:
        graph, args.graph_k = None, 0
    base_lo = (np.ascontiguousarray(read_fvecs(args.base_lo), dtype=np.float32)
               if args.base_lo else base)
    q_lo = (np.ascontiguousarray(read_fvecs(args.query_lo), dtype=np.float32)
            if args.query_lo else query)
    gt = np.asarray(read_ivecs(args.gt)) if args.gt else None
    return base, base_lo, query, q_lo, graph, gt


def _run_sharded(base, base_lo, query, q_lo, gt, ef, args):
    """Sharded run for ``search``/``sweep --n-devices N``: the first N
    cards, or N shards on ``--device`` when it is given."""
    from gbnns_tpu_torch.eval.bench import TIMING_MODE, BenchResult, time_search
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.search.sharded import (build_sharded_index,
                                                make_mesh, sharded_search)

    engine = getattr(args, "sharded_engine", "graph")
    idx = getattr(args, "_sharded_idx", None)
    if idx is None:
        mesh = make_mesh(args.n_devices, device=args.device)
        K = int(getattr(args, "graph_k", 0)) or 32
        idx = build_sharded_index(
            base, K, mesh, base_lo=base_lo, metric=args.metric,
            with_graph=engine in ("graph", "graph_pallas"),
            with_payload=engine == "graph_pallas",
            ncent=(args.centroid_entries or 64
                   if engine == "graph_pallas" else 0))
        args._sharded_idx = idx

    def run():
        return sharded_search(idx, q_lo, args.k, ef=ef,
                              num_entries=args.num_entries,
                              max_hops=args.max_hops, metric=args.metric,
                              engine=engine, queries_full=query,
                              scan_dtype=args.scan_dtype)

    qps, sec, (ids, _) = time_search(run, q_lo.shape[0], warmup=1, iters=3)
    ids = ids.cpu().numpy()
    r1 = recall_at_k(ids, gt, 1) if gt is not None else float("nan")
    r10 = (recall_at_k(ids, gt, min(10, args.k)) if gt is not None
           else float("nan"))
    return BenchResult(
        label=f"sharded-ef{ef}", ef=ef, qps=qps, latency_ms=sec * 1e3,
        recall_at_1=r1, recall_at_10=r10, n_queries=q_lo.shape[0],
        # scans: n reduced rows + each shard's ef-pool full-dim re-rank;
        # graph walks: data-dependent (null)
        dist_comps_per_query=(float(base.shape[0] + args.n_devices * ef)
                              if engine in ("flat", "fused") else None),
        hops=-1,
        extra={"n_devices": args.n_devices, "engine": engine,
               "scan_dtype": args.scan_dtype, "timing": TIMING_MODE}), ids


def _search_one(inputs, ef, args):
    """``search``'s and ``sweep``'s run at ``ef``: sharded, scan or graph
    walk, as the flags say."""
    base, base_lo, query, q_lo, graph, gt = inputs
    if args.n_devices and args.n_devices > 1:
        return _run_sharded(base, base_lo, query, q_lo, gt, ef, args)
    if args.engine in ("flat", "fused"):
        return _run_scan_engine(base, base_lo, query, q_lo, gt, ef, args)
    walker = "pallas" if args.engine == "graph_pallas" else args.walker
    return _run_search(base, base_lo, query, q_lo, graph, gt, ef, args.k,
                       args.metric, args.num_entries, args.max_hops,
                       args.visited_mode, expand=args.expand,
                       dtype=args.dtype, batch_size=args.batch_size,
                       packed=args.packed, walker=walker,
                       centroid_entries=args.centroid_entries,
                       device=args.device)


def cmd_search(args):
    from gbnns_tpu_torch.io.vecs import write_ivecs

    r, ids = _search_one(_load_search_inputs(args), args.ef, args)
    print(json.dumps(r.to_json(), indent=2))
    if args.out:
        write_ivecs(args.out, ids)
        print(f"wrote {args.out}")


def cmd_sweep(args):
    from gbnns_tpu_torch.eval.bench import sweep

    inputs = _load_search_inputs(args)
    efs = [int(e) for e in args.efs.split(",")]
    sweep(lambda ef: _search_one(inputs, ef, args)[0], efs,
          out_path=args.out)
    if args.out:
        print(f"wrote {args.out}")


def cmd_plot(args):
    from gbnns_tpu_torch.eval.plot import plot_results_files

    paths = {}
    for spec in args.results:
        label, _, path = spec.rpartition("=")
        if not label:
            label = os.path.splitext(os.path.basename(path))[0]
        paths[label] = path
    plot_results_files(paths, args.out, recall_key=args.recall_key)
    print(f"wrote {args.out}")


def cmd_size(args):
    """Print the resident device-memory breakdown of an engine config, the
    pre-check to run before a build. The JSON keeps the JAX package's keys;
    the warning line holds it against one 80 GB H100."""
    from gbnns_tpu_torch.search.sizing import (fused_index_hbm,
                                               graph_index_hbm,
                                               sharded_per_chip_hbm)

    rr = 2 if args.rerank_dtype == "bfloat16" else 4
    if args.chips > 1:
        b = sharded_per_chip_hbm(args.n, args.chips, args.d, args.d_lo,
                                 args.K, engine=args.engine,
                                 rerank_itemsize=rr)
    elif args.engine in ("graph_pallas", "graph"):
        b = graph_index_hbm(args.n, args.d, args.d_lo, args.K,
                            rerank_itemsize=rr)
    else:
        # flat keeps its scan corpus f32 in this figure, as the JAX
        # package's; fused casts to bf16 (or quantizes to int8)
        scan_item = (4 if args.engine == "flat"
                     else 1 if args.scan_dtype == "int8" else 2)
        b = fused_index_hbm(args.n, args.d, args.d_lo, rerank_itemsize=rr,
                            scan_itemsize=scan_item)
    out = b.as_dict()
    out["chips"] = args.chips
    print(json.dumps(out, indent=2))
    if not b.fits(80e9):
        print("does NOT fit an 80 GB H100 (with 2 GB scratch headroom); "
              "shard over more cards or use rerank-dtype=bfloat16",
              flush=True)


def cmd_pipeline(args):
    from gbnns_tpu_torch.config import ExperimentConfig
    from gbnns_tpu_torch.pipeline import run_pipeline

    if args.config:
        cfg = ExperimentConfig.load(args.config)
    else:
        cfg = ExperimentConfig(dataset=args.dataset, scale=args.scale,
                               max_base=args.max_base)
        if args.d_out:
            cfg.dimred.method = args.method or "linear"
            cfg.dimred.d_out = args.d_out
    results = run_pipeline(cfg, device=args.device)
    print(json.dumps(results["summary"], indent=2))


def cmd_serve(args):
    from gbnns_tpu_torch.serve import serve

    svc = build_service(args)
    if not args.no_warm:
        n = svc.warm(k=10)
        print(f"warmed {n} request-size buckets", flush=True)
    serve(svc, port=args.port, host=args.host)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gbnns_tpu_torch",
                                description="Graph-based NNS with learned "
                                            "dimensionality reduction, on "
                                            "PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_data_args(sp, query=True):
        sp.add_argument("--dataset", default="sift1m")
        sp.add_argument("--scale", type=float, default=1.0)
        sp.add_argument("--max-base", type=int, default=None, dest="max_base")
        sp.add_argument("--base", help="base.fvecs path (overrides --dataset)")
        if query:
            sp.add_argument("--query", help="query.fvecs path")
        sp.add_argument("--metric", default="l2",
                        choices=["l2", "ip", "angular"])
        sp.add_argument("--device", default=None,
                        help="cuda (default) or cpu")

    sp = sub.add_parser("synth", help="materialize dataset as fvecs")
    sp.add_argument("--dataset", default="sift1m")
    sp.add_argument("--scale", type=float, default=1.0)
    sp.add_argument("--max-base", type=int, default=None, dest="max_base")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_synth)

    sp = sub.add_parser("gt", help="exact ground truth → ivecs")
    add_data_args(sp)
    sp.add_argument("--k", type=int, default=100)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_gt)

    sp = sub.add_parser("build", help="kNN graph → npy")
    add_data_args(sp, query=False)
    sp.add_argument("--k", type=int, default=32)
    sp.add_argument("--chunk", type=int, default=65536)
    sp.add_argument("--node-chunk", type=int, default=8192, dest="node_chunk")
    sp.add_argument("--approx", action="store_true",
                    help="exact=False, as in the JAX package's build; "
                         "selection is exact in both backends here")
    sp.add_argument("--no-connect", action="store_true", dest="no_connect")
    sp.add_argument("--backend", default="xla", choices=["xla", "fused"],
                    help="candidate sweep: exact (fp32 products + topk) | "
                         "fused binned scan (kernels K1 and K2)")
    sp.add_argument("--verbose", action="store_true")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_build)

    sp = sub.add_parser("train", help="dimensionality-reduction projection")
    add_data_args(sp)
    sp.add_argument("--method", default="linear",
                    choices=["pca", "linear", "mlp"])
    sp.add_argument("--d-out", type=int, required=True, dest="d_out")
    sp.add_argument("--neighbors", help="ivecs of true-NN rows for sampling")
    sp.add_argument("--steps", type=int, default=2000)
    sp.add_argument("--batch-size", type=int, default=1024, dest="batch_size")
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--k-pos", type=int, default=10, dest="k_pos")
    sp.add_argument("--eval-every", type=int, default=0, dest="eval_every",
                    help="validation-gated checkpoint selection cadence "
                         "(0 = off; returns the best checkpoint incl. the "
                         "init by held-out NN-ordering preservation)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out", required=True, help="output directory")
    sp.set_defaults(fn=cmd_train)

    def add_search_args(sp):
        add_data_args(sp)
        sp.add_argument("--graph", help="adjacency npy (required for the "
                                        "graph engines; scan engines need "
                                        "none)")
        sp.add_argument("--engine", default="graph",
                        choices=["graph", "graph_pallas", "flat", "fused"],
                        help="one-device engine; for flat/fused the ef "
                             "value is the re-rank pool c")
        sp.add_argument("--scan-dtype", default="bfloat16",
                        dest="scan_dtype", choices=["bfloat16", "int8"])
        sp.add_argument("--base-lo", dest="base_lo")
        sp.add_argument("--query-lo", dest="query_lo")
        sp.add_argument("--gt")
        sp.add_argument("--k", type=int, default=10)
        sp.add_argument("--num-entries", type=int, default=32,
                        dest="num_entries")
        sp.add_argument("--max-hops", type=int, default=256, dest="max_hops")
        sp.add_argument("--visited-mode", default="beam",
                        choices=["beam", "exact"], dest="visited_mode")
        sp.add_argument("--expand", type=int, default=4)
        sp.add_argument("--batch-size", type=int, default=0, dest="batch_size",
                        help="query micro-batch (0 = whole set)")
        sp.add_argument("--packed", action="store_true",
                        help="inline (K,d) neighbor rows (pack_neighbors)")
        sp.add_argument("--walker", default="jax",
                        choices=["jax", "pallas"],
                        help="graph-walk hop: plain gathers, or payload "
                             "rows fetched by kernel K3")
        sp.add_argument("--centroid-entries", type=int, default=0,
                        dest="centroid_entries",
                        help=">0: per-query k-means entry points "
                             "(value = number of centroids)")
        sp.add_argument("--sharded-engine", default="graph",
                        dest="sharded_engine",
                        choices=["graph", "graph_pallas", "flat", "fused"],
                        help="per-shard engine for --n-devices runs "
                             "(graph_pallas = payload walker + per-shard "
                             "centroid entries)")
        sp.add_argument("--n-devices", type=int, default=None,
                        dest="n_devices",
                        help=">1: shard base and graph over the first N "
                             "cards, or N shards on --device")
        sp.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])

    sp = sub.add_parser("search", help="single search run")
    add_search_args(sp)
    sp.add_argument("--ef", type=int, default=64)
    sp.add_argument("--out", help="write result ids as ivecs")
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("sweep", help="recall-vs-QPS over ef sweep")
    add_search_args(sp)
    sp.add_argument("--efs", default="16,32,64,128,256")
    sp.add_argument("--out", help="results JSON path")
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("plot", help="recall-vs-QPS curves from sweep JSONs")
    sp.add_argument("results", nargs="+",
                    help="result files, optionally label=path")
    sp.add_argument("--recall-key", default="recall_at_10", dest="recall_key")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_plot)

    sp = sub.add_parser("size", help="resident device-memory pre-check for "
                                     "an engine config (no device needed)")
    sp.add_argument("--engine", default="fused",
                    choices=["fused", "flat", "graph", "graph_pallas"])
    sp.add_argument("--n", type=int, required=True)
    sp.add_argument("--d", type=int, required=True)
    sp.add_argument("--d-lo", type=int, dest="d_lo", required=True)
    sp.add_argument("--K", type=int, default=32)
    sp.add_argument("--chips", type=int, default=1,
                    help=">1: per-device residency on a sharded mesh")
    sp.add_argument("--rerank-dtype", dest="rerank_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    sp.add_argument("--scan-dtype", dest="scan_dtype", default="bfloat16",
                    choices=["bfloat16", "int8"])
    sp.set_defaults(fn=cmd_size)

    sp = sub.add_parser("pipeline", help="full experiment from config")
    sp.add_argument("--config", help="config JSON (configs/*.json)")
    sp.add_argument("--dataset", default="sift1m")
    sp.add_argument("--scale", type=float, default=1.0)
    sp.add_argument("--max-base", type=int, default=None, dest="max_base")
    sp.add_argument("--method", choices=["pca", "linear", "mlp"])
    sp.add_argument("--d-out", type=int, default=0, dest="d_out")
    sp.add_argument("--device", default=None, help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_pipeline)

    sp = sub.add_parser("serve", help="HTTP search service over staged artifacts")
    add_data_args(sp, query=False)
    sp.add_argument("--base-lo", dest="base_lo")
    sp.add_argument("--graph", help="adjacency npy (the graph engines)")
    sp.add_argument("--proj", help="projection checkpoint (proj.npz) to project raw queries")
    sp.add_argument("--engine", default="flat",
                    choices=["flat", "fused", "graph", "graph_pallas"])
    sp.add_argument("--ef", type=int, default=64)
    sp.add_argument("--c", type=int, default=64)
    sp.add_argument("--port", type=int, default=8390)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--scan-dtype", default="bfloat16", dest="scan_dtype",
                    choices=["bfloat16", "int8"],
                    help="fused engine corpus dtype (the re-rank absorbs "
                         "the int8 rounding)")
    sp.add_argument("--centroids", default=None,
                    help="staged CentroidEntries npz for graph_pallas "
                         "(skips the k-means fit)")
    sp.add_argument("--no-warm", action="store_true", dest="no_warm",
                    help="skip the warm-up search at every request-size bucket")
    sp.add_argument("--h2d-dtype", dest="h2d_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="upload dtype for coalesced query batches; "
                         "bfloat16 halves the bytes")
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
