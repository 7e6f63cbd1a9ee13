"""``python -m gbnns_tpu_torch.cli`` — the port's command line.

  serve     HTTP search service over staged artifacts (engines fused, flat)

The other subcommands of the JAX package's ``gbnns`` CLI (synth, gt, build,
train, search, sweep, plot, size, pipeline) are still to be ported
(ROADMAP.md). ``serve`` takes the same flags as there, plus ``--device``.
"""

from __future__ import annotations

import argparse

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
    from gbnns_tpu_torch.io.vecs import read_fvecs
    from gbnns_tpu_torch.serve import SearchService

    if args.graph or args.centroids:
        raise NotImplementedError(
            "--graph and --centroids need the graph engines, still to be "
            "ported: ROADMAP.md slice 2")
    base, _ = _load_base_query(args)
    base_lo = (np.ascontiguousarray(read_fvecs(args.base_lo), dtype=np.float32)
               if args.base_lo else None)
    projection = None
    if args.proj:
        from gbnns_tpu_torch.dimred.train import load_projection, projector

        projection = projector(load_projection(args.proj, device=args.device))
    return SearchService(base, base_lo, metric=args.metric,
                         engine=args.engine, ef=args.ef, c=args.c,
                         projection=projection, scan_dtype=args.scan_dtype,
                         h2d_dtype=args.h2d_dtype, device=args.device)


def cmd_serve(args):
    from gbnns_tpu_torch.serve import serve

    svc = build_service(args)
    if not args.no_warm:
        n = svc.warm(k=10)
        print(f"warmed {n} request-size buckets", flush=True)
    serve(svc, port=args.port, host=args.host)


def main(argv=None):
    p = argparse.ArgumentParser(prog="gbnns_tpu_torch",
                                description="Graph-based NNS with learned "
                                            "dimensionality reduction, on "
                                            "PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve", help="HTTP search service over staged artifacts")
    sp.add_argument("--dataset", default="sift1m")
    sp.add_argument("--scale", type=float, default=1.0)
    sp.add_argument("--max-base", type=int, default=None, dest="max_base")
    sp.add_argument("--base", help="base.fvecs path (overrides --dataset)")
    sp.add_argument("--metric", default="l2", choices=["l2", "ip", "angular"])
    sp.add_argument("--base-lo", dest="base_lo")
    sp.add_argument("--graph", help="graph engines: not ported yet")
    sp.add_argument("--proj", help="projection checkpoint (proj.npz) to project raw queries")
    sp.add_argument("--engine", default="flat", choices=["flat", "fused"])
    sp.add_argument("--ef", type=int, default=64)
    sp.add_argument("--c", type=int, default=64)
    sp.add_argument("--port", type=int, default=8390)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--scan-dtype", default="bfloat16", dest="scan_dtype",
                    choices=["bfloat16", "int8"],
                    help="fused engine corpus dtype (the re-rank absorbs "
                         "the int8 rounding)")
    sp.add_argument("--centroids", default=None,
                    help="graph engines' centroid entries: not ported yet")
    sp.add_argument("--no-warm", action="store_true", dest="no_warm",
                    help="skip the warm-up search at every request-size bucket")
    sp.add_argument("--h2d-dtype", dest="h2d_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="upload dtype for coalesced query batches; "
                         "bfloat16 halves the bytes")
    sp.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
