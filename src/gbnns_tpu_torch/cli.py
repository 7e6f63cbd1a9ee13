"""``python -m gbnns_tpu_torch.cli`` — the port's command line.

  synth     materialize a dataset as base.fvecs and query.fvecs
  gt        exact ground truth → ivecs
  build     kNN graph → npy (backends xla, fused)
  train     projection (pca | linear | mlp) → pca.npz or proj.npz, then
            base_lo.fvecs and query_lo.fvecs
  serve     HTTP search service over staged artifacts (engines fused, flat,
            graph, graph_pallas)

The other subcommands of the JAX package's ``gbnns`` CLI (search, sweep,
plot, size, pipeline) are still to be ported (ROADMAP.md). The ported ones
take the same flags as there, plus ``--device`` where they compute.
"""

from __future__ import annotations

import argparse
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
