"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA GPU: the fused
scan (binned and shifted), the cluster-gated scan, the IVF index, the
projection trainer, the exact fused kNN, the graph walker, the experiment
driver and the sharded engine.

    python3 chip_smoke.py

Run from the root of a checkout of this repository (it imports
``src/gbnns_tpu_torch`` from beside this file and nothing of JAX). Phases,
each printing its wall time:

0. the card's name and power limit (nvidia-smi);
1. build the CUDA kernels, one nvcc process per source, all started
   together, into .kernel_build/;
2. the contract corpus: synthetic SIFT-like n = 1,000,000 x 128 and 16,384
   queries from seed 0, the trained 128→32 projection and the cached exact
   ground truth under results/; the port's exact kNN must reproduce that
   ground truth on the first 1,024 queries;
3. each scan kernel (K1 binned_scan in bf16, int8, f32 and fp16, and at a
   reduced width of 160; K2 merge_topc, bit-equal, also timed as the
   device time of CUDA-graph replays) against its plain PyTorch version
   on the serving shapes, on the route scan_cores gives it (tensor cores
   for bf16, fp16 and int8 at d = 32; CUDA cores for f32 and d = 160),
   with its time, the CUDA-core kernel's on the same inputs (the only
   route before the tensor-core redesign), the plain version's, one
   PyTorch library call's and the least time the card could take (bound); the f32 and fp16 kinds, on no engine of the
   service, then answer all queries through FusedScanIndex.search, with
   their launch counts (by route as well) and R@10;
4. serving: SearchService(engine="fused") in bf16 (c = 12) and int8
   (c = 16): requests through submit() and HTTP /search, /search_raw on an
   ephemeral localhost port, then the 16,384 queries, with R@1, R@10 and
   QPS (median of ten requests), the recall run with the launch counts set
   to 0 before and read after, every K1 launch on the tensor cores and one
   K2 launch a K1 launch; R@10
   must lie within 0.005 of the JAX reference's rows on these inputs; in
   bf16, three more requests under the profiler (eval.trace.profile_trace,
   the Chrome trace written to .traces/request/) and where their
   time goes: device time by named stage (upload, projection, K1, K2,
   re-rank, copy), host spans, and the device's idle share;
5. the shifted scan: FusedScanIndex(mode="shifted", bf16) with its build
   seconds and the width T3 takes; all queries at c = 12 with the launch
   counts set to 0 before and read after (one T3 launch, on the tensor
   cores, no K2), R@10 within 0.005 of this run's binned bf16 R@10, and
   the median of ten searches; T3 against its plain version at the
   serving shape (values within SCAN_RTOL plus one key quantum, ids equal
   except at counted near-ties) and, at B = 2,048, in fp16 and f32; its
   record: T3 ms (median of five), the CUDA-core kernel's on the same
   inputs, bound, plain ms and a bf16 torch.matmul of the same augmented
   operands;
6. the gated scan: GatedScanIndex at its defaults (fine 32, m 16, sub
   1024, chunk 16384, tq 512, seed 0) with its build seconds (k-means,
   assignment, packing, upload) and stats; T4 gated_topm against its plain
   version on all queries planned at probes 16, on the route gated_cores
   gives it (tensor cores for bf16 at the index's geometry; values within
   SCAN_RTOL plus one key quantum, ids equal except at counted
   near-ties), with its time, the CUDA-core kernel's on the same operands
   (the only route before the tensor-core redesign; held against plain
   the same way), the plain version's,
   the bound from the run's kept cells and the full bf16 matmul as a
   yardstick; then probes 4, 8, 16, 32 at c = 32, each search of all
   queries with the launch counts set to 0 before and read after (one T4
   launch a search, on the tensor cores), R@1, R@10, the kept-cell
   fraction, QPS (median of ten synchronized searches) and T4's time on
   both routes; R@10 must not fall as probes grows (within
   tests/test_gated.py's slack) and reach 0.95 at probes 32;
7. the IVF index: IVFIndex.build at its defaults (seed 0) with its seconds
   and stats (ncent 4096 and cap 488 as in BENCH_r05.json; the spill
   beside the JAX package's 4,361), then probes 8, 16, 32 at c = 32 with
   R@1, R@10, QPS (median of ten synchronized searches) and the peak
   device memory of a search; R@10 must not fall as probes grows and not
   lie below the JAX reference (0.8885, 0.9457, 0.9773) less 0.005; one
   search under set_sync_debug_mode("error") (no wait for the host); one
   search at probes 32 under the profiler (.traces/ivf/), its
   device time by stage;
8. the projection trainer at bench.py's recipe: the 262,144-row subsample
   of default_rng(1), its exact in-sample neighbours (k_pos 10), 600 steps
   of batch 1024, validation every 150; its seconds, val history and best
   step; every loss finite and the selected val not below step 0's; a
   bf16 FusedScanIndex over the new projection answers all queries at
   c = 12 with R@10 at least 0.95 (the cached projection reads 0.9622);
9. graph build on the projected corpus: build_knn_graph(backend="fused",
   K = 32) on K1 and K2, with the seconds of the sweep, the reverse edges
   and the reachability repair, and the launch counts set to 0 before and
   read after, every K1 launch on the tensor cores and one K2 launch a node
   chunk; K1 in its packed form and K2 at c = K + 1 against their
   plain versions on one 8,192-node chunk of the build's own operands;
   every node reachable from the walker's entries; edge overlap with the
   exact build's graph on 1,024 sampled nodes at least the JAX package's
   0.7874 less 0.02; centroid entries (n / 256 centroids) and the bf16 hop
   payload;
10. the exact fused kNN (T6 knn_topk) at the build's shape: 8,192 rows of
   the projected corpus against all of it, k = 33, l2, f32, with the launch
   count set to 0 before and read after; held against knn_chunked (within
   1e-5 of the largest distance, ids equal except at near-ties) and, on
   1,024 queries, against its plain version in l2, ip and bf16; its record
   with knn_chunked's time as the yardstick (no single PyTorch call
   computes an exact k-NN) and an fp32 torch.matmul of the same shape;
11. K3 row_gather against its plain version on 65,536 rows of that payload,
   and its time beside torch.index_select's: medians of interleaved rounds;
12. walker vs plain: 1,024 queries walked with K3 and with the plain
   gather, identical; the f32-payload walk identical to the plain walker's;
13. serving: SearchService(engine="graph_pallas") over the 16,384 queries
   at ef = 32, 48, 64 (submit() and HTTP), with R@1, R@10, K3 launches per
   request (one per hop) and QPS; R@10 at ef = 64 at least 0.95 and not
   falling as ef grows;
14. the experiment driver: run_pipeline on configs/sift1m_dr32.json at
   full width (its synthetic SIFT-like fallback, 1M x 128 and 10,000
   queries; the linear 128→32 projection trained for 2,000 steps with
   validation every 500; the exact reduced-space graph; graph_pallas swept
   over ef 32, 64, 128 with 1,024 centroid entries), writing into the
   ignored chiprun_out/pipeline_sift1m_dr32/ (never results/); the
   dataset's source, each stage's seconds and every row, with K3's
   launches set to 0 before the run and read after; R@10 at ef 64 at least
   0.95 and not falling as ef grows; K3 against its plain version on rows
   of the walker's f32 payload shape (K 32, d 32, 4 rows a query);
15. the sharded engine: make_mesh(8) with all 8 shards on this one card,
   over the contract corpus: fused bf16 and int8 at ef 32 (no graph), then
   graph_pallas at ef 32 (per-shard exact graphs, bf16 payloads, 64
   centroid entries a shard), each over all queries with the launch counts
   set to 0 before and read after (K1 and K2 once a shard, on the tensor
   cores; K3 once a hop a shard), R@1, R@10 (at least 0.95 each) and the
   median search time; shard 0's K1 (131,072 rows, bins of 512) and K2
   (c = 32) against their plain versions with their records. Every time
   is of 8 shards sharing one card: the per-shard kernels and the merge,
   not the speed of several cards;
16. teardown: services stopped, HTTP servers shut down, threads joined.

The last two lines are the kernels' JSON record and the device line. Any
failed check exits non-zero; without a CUDA device the script exits 1 before
printing anything on stdout.
"""

from __future__ import annotations

import http.client
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

sys.dont_write_bytecode = True  # write nothing into the checkout but builds
#                                 and the profiler traces (.traces/)

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# The JAX reference's recall on exactly these inputs (BENCH_r05.json:
# engine_bests fused c=12 and fused_int8 c=16; the same numbers are in
# results/bench_1m_learned_r5.json).
REFERENCE = {"bfloat16": {"c": 12, "r1": 0.9999, "r10": 0.9622},
             "int8": {"c": 16, "r1": 0.9999, "r10": 0.9890}}
R10_TOL = 0.005
SCAN_RTOL = 1e-5     # fp32 sums in another order than the plain matmul
# The fused graph build's edge overlap with the exact build's graph, from
# the JAX package on these inputs (results/build_time_1m.json), less 0.02;
# and the graph walker's recall target (results/walker_ab_1m.json).
OVERLAP_MIN = 0.7874 - 0.02
GRAPH_R10_MIN = 0.95
GRAPH_K = 32
GRAPH_EFS = (32, 48, 64)
BUILD_CHUNK = 8192    # the fused build's node chunk (build_knn_graph's)
PEAK_BYTES_S = 3.35e12                      # H100 SXM HBM3
# dense tensor cores (bf16, int8); fp32 on the CUDA cores
PEAK_OPS_S = {"bfloat16": 989e12, "float16": 989e12, "int8": 1979e12,
              "float32": 67e12}
# the gated scan's sweep (at c = 32) and its recall target at probes 32,
# the repo's graph target (JAX's TPU run with a PCA projection read 0.9902
# at probes 32, results/gated_1m.json: a comparison, not a target)
GATED_PROBES = (4, 8, 16, 32)
GATED_C = 32
GATED_R10_MIN = 0.95
# the IVF index at bench.py's settings and the JAX reference's R@10 at c = 32
# (BENCH_r05.json: ncent 4096, cap 488, spill 4,361 on the TPU)
IVF_C = 32
IVF_R10 = {8: 0.8885, 16: 0.9457, 32: 0.9773}
IVF_SHAPE = {"ncent": 4096, "cap": 488}
IVF_JAX_SPILL = 4361
# the trainer at bench.py's recipe, and the fused bf16 row its projection
# must serve (the cached projection reads 0.9622 there)
TRAIN_STEPS = 600
REDUCED_DIM = 32
TRAIN_R10_MIN = 0.95
# three served bf16 requests, and one IVF search at probes 32, under the
# profiler; the traces stay in the ignored .traces/
TRACE_REQUESTS = 3
TRACE_DIR = ROOT / ".traces"
# the shifted scan's check of its fp16 and f32 kinds; the exact kNN's
# shape (the graph build's node chunk and K + 1) and its slices
SHIFTED_KIND_B = 2048
KNN_Q = BUILD_CHUNK
KNN_K = GRAPH_K + 1
KNN_SLICE = 1024
# the experiment driver on configs/sift1m_dr32.json (its synthetic SIFT-like
# fallback: 1M x 128, 10,000 queries), its graph gate at ef 64 (PERF.md §2),
# and where it writes: an ignored directory, never results/
PIPELINE_CONFIG = ROOT / "configs" / "sift1m_dr32.json"
PIPELINE_OUT = ROOT / "chiprun_out" / "pipeline_sift1m_dr32"
PIPELINE_GATE_EF = 64
# the sharded engine on the contract corpus: 8 shards, all on the one card,
# at ef 32 with 64 centroid entries a shard (the pipeline's _sharded_sweep),
# and the gate of MULTICHIP_r05.json / __graft_entry__.py
SHARDS = 8
SHARDED_EF = 32
SHARDED_NCENT = 64
SHARDED_R10_MIN = 0.95
SCAN_SOURCE = "src/gbnns_tpu_torch/kernels/csrc/scan_topk.cu"
SHIFTED_SOURCE = "src/gbnns_tpu_torch/kernels/csrc/shifted_scan.cu"
GATED_SOURCE = "src/gbnns_tpu_torch/kernels/csrc/gated_topm.cu"
GATHER_SOURCE = "src/gbnns_tpu_torch/kernels/csrc/gather.cu"
KNN_SOURCE = "src/gbnns_tpu_torch/kernels/csrc/distance_topk.cu"
KERNEL_SOURCES = ("scan_topk", "shifted_scan", "gated_topm", "gather",
                  "distance_topk")
REPLACES = {"binned_scan": "src/gbnns_tpu/kernels/scan_topk_pallas.py:44",
            "merge_topc": "src/gbnns_tpu/kernels/scan_topk_pallas.py:559",
            "shifted_scan": "src/gbnns_tpu/kernels/scan_topk_pallas.py:133",
            "gated_topm": "src/gbnns_tpu/kernels/scan_topk_pallas.py:397",
            "row_gather": "src/gbnns_tpu/kernels/gather_pallas.py:40",
            "knn_topk": "src/gbnns_tpu/kernels/distance_topk_pallas.py:48"}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(*a) -> None:
    print(*a, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        say(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        say(f"-- {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def time_ms(fn, iters: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events), after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``reps`` single calls of ``fn`` (CUDA events
    around each), after one warm-up call."""
    import numpy as np
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, the graph replayed twice between CUDA events, after a warm-up.
    For a kernel of tens of microseconds this leaves out the host's launch
    gaps, which ``time_ms`` counts."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * iters)


def bound_ms(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def load_data(device, n: int, nq: int, proj_file: str):
    import numpy as np

    from gbnns_tpu_torch.dimred.train import load_projection, project
    from gbnns_tpu_torch.eval.recall import exact_ground_truth
    from gbnns_tpu_torch.io.synthetic import SyntheticSpec, make_synthetic

    t0 = time.perf_counter()
    data = make_synthetic(SyntheticSpec(n_base=n, n_query=nq, dim=128,
                                        n_clusters=max(64, n // 2000),
                                        seed=0))
    base, query = data["base"], data["query"]
    say(f"corpus {base.shape} queries {query.shape}: "
        f"{time.perf_counter() - t0:.2f} s")
    trained = load_projection(str(ROOT / "results" / proj_file),
                              device=device)
    t0 = time.perf_counter()
    base_lo = project(trained, base)
    say(f"projected corpus {base_lo.shape}: {time.perf_counter() - t0:.2f} s")
    with np.load(ROOT / "results" / f"bench_gt_n{n}_q{nq}_seed0.npz") as f:
        gt = f["gt"]
    m = min(1024, nq)
    t0 = time.perf_counter()
    mine = exact_ground_truth(query[:m], base, k=gt.shape[1], device=device)
    say(f"exact kNN of {m} queries: {time.perf_counter() - t0:.2f} s")
    differ = np.nonzero((mine != gt[:m]).any(axis=1))[0]
    # a row may differ only where two true distances tie to fp32 rounding
    for r in differ:
        dm = ((base[mine[r]].astype(np.float64) - query[r]) ** 2).sum(-1)
        dg = ((base[gt[r]].astype(np.float64) - query[r]) ** 2).sum(-1)
        check(np.allclose(np.sort(dm), np.sort(dg), rtol=1e-6, atol=0),
              f"ground truth row {r} differs beyond a tie")
    say(f"ground truth: {m - differ.size}/{m} rows equal, "
        f"{differ.size} differ only at exact-distance ties")
    return base, query, base_lo, gt, trained


def route_counts(st, kernel: str) -> dict:
    """``kernel``'s launches by route since the counts were last reset."""
    return {c: st.launches_by_cores[f"{kernel}:{c}"]
            for c in ("tensor", "cuda")}


def main_path_route(records, name: str, kernel: str, cores: str,
                    counts: dict, device, what: str) -> None:
    """Record the route ``cores`` of a main path's K1, T3 or T4 and its
    launches by route (``counts``, read after the run); on the card every
    launch must have taken the tensor cores."""
    records.setdefault(name, {}).update(cores=cores,
                                        launches_by_cores=counts)
    say(f"{what}: {kernel} routed to the {cores} cores, launches by route "
        f"{counts}")
    if device.type == "cuda":
        check(cores == "tensor" and counts["cuda"] == 0
              and counts["tensor"] > 0,
              f"{what}: a {kernel} launch took the CUDA cores: {counts}")


def _scan_check(st, args, kw: dict, label: str, plain_iters: int = 2):
    """K1 on ``args = (q, x, addvec, alpha)`` and options ``kw`` against its
    plain version, on the route ``scan_cores`` gives it (the launch is
    counted there); returns the scan's outputs and its record (times,
    bound, and ``earlier_ms``: the CUDA-core kernel on the same inputs,
    the only route before the tensor-core redesign; the library yardstick
    is filled by the caller)."""
    import torch

    q_scan, x, _, alpha = args
    B, d = q_scan.shape
    cores = st.scan_cores(x.dtype, d, kw["bin_size"])
    before = route_counts(st, "binned_scan")[cores]
    got = st.binned_scan(*args, **kw)
    ref = st.binned_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    if x.device.type == "cuda":
        check(route_counts(st, "binned_scan")[cores] == before + 1,
              f"K1 {label} did not launch on the {cores} cores")
    rep = st.scan_agreement(got, ref, *args, rtol=SCAN_RTOL, **kw)
    say(f"K1 binned_scan[{label}] vs plain ({cores} cores): {rep}")
    check(rep["ok"], f"K1 {label} disagrees with its plain version")
    n_pad = x.shape[0]
    n_bins = n_pad // kw["bin_size"]
    ms = time_ms(lambda: st.binned_scan(*args, **kw))
    earlier_ms = (ms if cores == "cuda" else
                  time_ms(lambda: st.binned_scan(*args, **kw, cores="cuda")))
    plain_ms = time_ms(lambda: st.binned_scan_plain(*args, **kw), plain_iters)
    el = q_scan.element_size()
    n_bytes = (B * d * el + n_pad * d * el + n_pad * 4
               + (B * 4 if alpha is not None else 0) + n_bins * B * 8)
    dtype = str(x.dtype).removeprefix("torch.")
    b_ms, b_by = bound_ms(n_bytes, 2.0 * B * n_pad * d, dtype)
    name = f"binned_scan[{label}]"
    rec = dict(name=name, route="cuda", source=SCAN_SOURCE,
               replaces=REPLACES["binned_scan"], launches=None,
               max_abs_err=rep["max_abs_err"], ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None, cores=cores,
               earlier_ms=earlier_ms)
    say(f"K1 [{label}] B={B} n_pad={n_pad} d={d} on the {cores} cores: "
        f"{ms:.3f} ms (CUDA-core kernel {earlier_ms:.3f} ms), plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return got, rec


def _merge_check(st, vals, ids, c: int, label: str) -> dict:
    """K2 at ``c`` on bin winners ``vals/ids`` against its plain version
    (equal); returns its record: ``ms`` as every kernel's (eager calls),
    ``graph_ms`` the device time of CUDA-graph replays of the same call."""
    import torch

    gm = st.merge_topc(vals, ids, c)
    rm = st.merge_topc_plain(vals, ids, c)
    torch.cuda.synchronize()
    equal = torch.equal(gm[0], rm[0]) and torch.equal(gm[1], rm[1])
    err = (gm[0] - rm[0]).abs().nan_to_num(0.0).max().item()
    say(f"K2 merge_topc[{label}] equals plain: {equal}")
    check(equal, f"K2 ({label}) differs from its plain version")
    R, B = vals.shape
    ms = time_ms(lambda: st.merge_topc(vals, ids, c))
    # a call lasts tens of microseconds: also without the host's gaps
    g_ms = graph_ms(lambda: st.merge_topc(vals, ids, c))
    plain_ms = time_ms(lambda: st.merge_topc_plain(vals, ids, c), 2)
    vt = vals.T.contiguous()
    lib_ms = time_ms(lambda: torch.topk(vt, c, dim=1, largest=False))
    # the values once, one 32-byte sector a winner's id, the output
    b_ms, b_by = bound_ms(R * B * 4 + B * c * 32 + B * c * 8, 0.0,
                          "bfloat16")
    say(f"K2 [{label}] R={R} B={B}: {ms:.4f} ms ({g_ms:.4f} ms in CUDA-graph "
        f"replays), plain {plain_ms:.3f} ms, topk {lib_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms")
    return dict(name=f"merge_topc[{label}]", route="cuda", source=SCAN_SOURCE,
                replaces=REPLACES["merge_topc"], launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, cores="cuda",
                earlier_ms=None, graph_ms=g_ms)


def _index_args(idx, qlo):
    """The scan operands and options of FusedScanIndex ``idx`` on ``qlo``."""
    q_scan, alpha = idx.scan_queries(qlo)
    return ((q_scan, idx.x_lo, idx.addvec, alpha),
            dict(bin_size=idx.bin_size, packed=idx.packed))


def kernel_checks(base, query, base_lo, gt, trained, device, records,
                  targets: bool):
    """Each scan kernel against its plain version on the serving shapes.
    The f32 and fp16 kinds serve no engine of SearchService (which scans
    int8 or bf16, as the JAX service does): their launches and recall come
    from FusedScanIndex(scan_dtype=...).search of all the queries."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.kernels import scan_topk as st

    qf = torch.from_numpy(query).to(device)
    qlo = projector(trained)(qf)
    for dtype in ("bfloat16", "int8", "float32", "float16"):
        idx = st.FusedScanIndex(base, base_lo, scan_dtype=dtype, device=device)
        args, kw = _index_args(idx, qlo)
        got, rec = _scan_check(st, args, kw, dtype)
        if dtype in ("bfloat16", "float16"):
            # yardstick: the bare score product, (n_pad, B) bf16 in memory
            rec["library_ms"] = time_ms(
                lambda: torch.matmul(idx.x_lo, args[0].T), 3)
            torch.cuda.empty_cache()
        # int8: an int8 product's int32 scores would take 65 GB; f32: its
        # f32 scores 66 GB. No single library call fits: library_ms null.
        say(f"K1 [{dtype}] library {rec['library_ms']} ms")
        records[rec["name"]] = rec
        if dtype in ("float32", "float16"):
            del got, args
            c = REFERENCE["bfloat16"]["c"]
            st.reset_launches()
            ids = idx.search(qf, qlo, k=10, c=c)[0].cpu().numpy()
            rec["launches"] = st.launches["binned_scan"]
            rec["launches_by_cores"] = route_counts(st, "binned_scan")
            r10 = recall_at_k(ids, gt, 10)
            say(f"FusedScanIndex({dtype}).search, c={c}: R@10={r10:.4f}, "
                f"launches binned_scan {rec['launches']}, by route "
                f"{rec['launches_by_cores']}")
            check(rec["launches"] > 0, f"the {dtype} search launched no K1")
            check(rec["launches_by_cores"][rec["cores"]] == rec["launches"],
                  f"the {dtype} search left its route {rec['cores']}")
            if targets:
                check(r10 >= REFERENCE["bfloat16"]["r10"] - R10_TOL,
                      f"the {dtype} scan's R@10 {r10:.4f} falls below "
                      f"bf16's")
            del idx
            torch.cuda.empty_cache()
            continue

        c = REFERENCE[dtype]["c"]
        rec = _merge_check(st, *got, c, f"{dtype},c={c}")
        records[rec["name"]] = rec
        del idx, got, args
        torch.cuda.empty_cache()

    # a reduced width above 128 takes the wide kernel: a seeded 128→160
    # projection of the corpus, 2,048 queries
    w = np.random.default_rng(160).normal(size=(128, 160)).astype(np.float32)
    wt = torch.from_numpy(w).to(device)
    lo160 = (torch.from_numpy(base).to(device) @ wt).cpu().numpy()
    idx = st.FusedScanIndex(base, lo160, device=device)
    _scan_check(st, *_index_args(
        idx, torch.from_numpy(query[:2048]).to(device) @ wt), "bfloat16,d=160")
    del idx, lo160
    torch.cuda.empty_cache()
    return records


def gather_check(payload, n_rows: int, device, records,
                 name: str = "row_gather"):
    """K3 against its plain version on ``n_rows`` rows of ``payload``, ids
    from a seeded generator: bit-exact. Its record goes under ``name``,
    keeping the launches a main path counted there."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.kernels import gather

    ids = np.random.default_rng(3).integers(0, payload.n, n_rows)
    idx = torch.from_numpy(ids.astype(np.int32)).to(device)
    got = gather.row_gather(payload.data, idx)
    ref = gather.row_gather_plain(payload.data, idx)
    torch.cuda.synchronize()
    equal = torch.equal(got.view(torch.int32), ref.view(torch.int32))
    say(f"K3 {name} vs plain ({n_rows} rows of {payload.words * 4} B): "
        f"bit-exact {equal}")
    check(equal, "K3 differs from its plain version")
    # the walker's call: its ids need no check
    ms = time_ms(lambda: gather.row_gather(payload.data, idx,
                                           check_ids=False), 20)
    plain_ms = time_ms(lambda: gather.row_gather_plain(payload.data, idx,
                                                       check_ids=False), 20)
    lib_ms = time_ms(lambda: torch.index_select(payload.data, 0, idx), 20)
    # K3 against index_select: medians of nine interleaved rounds
    fns = {"row_gather": lambda: gather.row_gather(payload.data, idx,
                                                   check_ids=False),
           "index_select": lambda: torch.index_select(payload.data, 0, idx)}
    rounds = {fn: [] for fn in fns}
    for r in range(9):
        for fn in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            rounds[fn].append(time_ms(fns[fn], 20))
    med = {fn: float(np.median(t)) for fn, t in rounds.items()}
    row_bytes = payload.words * 4
    b_ms, b_by = bound_ms(2 * n_rows * row_bytes + n_rows * 4, 0.0,
                          "bfloat16")
    rec = records.setdefault(name, {})
    rec.update(
        name=name, route="cuda", source=GATHER_SOURCE,
        replaces=REPLACES["row_gather"], launches=rec.get("launches"),
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, median_ms=med["row_gather"],
        library_median_ms=med["index_select"])
    say(f"K3 {name} [{n_rows} x {row_bytes} B]: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); "
        f"{2 * n_rows * row_bytes / ms / 1e6:.0f} GB/s moved; medians of "
        f"nine interleaved rounds of 20 calls: K3 "
        f"{med['row_gather']:.4f} ms, index_select "
        f"{med['index_select']:.4f} ms")


def _post(port: int, path: str, body: bytes, ctype: str) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        payload = resp.read()
        check(resp.status == 200, f"{path} answered {resp.status}: "
              f"{payload[:200]!r}")
        return payload
    finally:
        conn.close()


def _serve(svc, label: str, query, gt, direct_fn, counters: dict,
           timed: int, trace: bool = False) -> dict:
    """Requests through ``svc`` (submit() from four threads, one HTTP
    /search_raw and one /search) held against ``direct_fn(rows)``, the same
    search without the service; then the main path: all queries as one
    request with every launch count in ``counters`` (module → names) set to
    0 before and read after, and ``timed`` more requests on the host clock;
    with ``trace``, ``traced`` requests after them. Stops the service and its
    HTTP server. Returns recall, QPS and counts."""
    import numpy as np

    from gbnns_tpu_torch.serve import (make_server, pack_raw_request, serve,
                                       unpack_raw_response)

    httpd = make_server(svc, 0, "127.0.0.1")
    port = httpd.server_address[1]
    server = threading.Thread(target=serve, args=(svc,),
                              kwargs={"httpd": httpd}, name="smoke-http")
    server.start()
    try:
        # direct search of the same rows is the yardstick for each request
        direct_ids = direct_fn(query[:300])
        results = {}
        # a request's rows ride in a batch of another size than the direct
        # search's, where cuBLAS may sum the projection in another order;
        # a last-bit change can move a candidate, so rows are compared as
        # a pool: at least 99 % must be equal
        equal_rows = []

        def ask(lo, hi):
            results[(lo, hi)] = svc.submit(query[lo:hi], None, 10)[0]

        askers = [threading.Thread(target=ask, args=span)
                  for span in ((0, 1), (1, 8), (8, 100), (100, 164))]
        for t in askers:
            t.start()
        for t in askers:
            t.join(60)
        check(len(results) == 4, "submit() requests did not all return")
        for (lo, hi), ids in results.items():
            equal_rows.append((ids == direct_ids[lo:hi]).all(axis=1))
        raw = _post(port, "/search_raw",
                    pack_raw_request(query[164:300], 10),
                    "application/octet-stream")
        ids, dists = unpack_raw_response(raw)
        check(ids.shape == (136, 10) and np.isfinite(dists).all(),
              "/search_raw answer malformed")
        equal_rows.append((ids == direct_ids[164:300]).all(axis=1))
        js = json.loads(_post(port, "/search", json.dumps(
            {"queries": query[:2].tolist(), "k": 10}).encode(),
            "application/json"))
        equal_rows.append((np.asarray(js["ids"]) == direct_ids[:2]).all(axis=1))
        share = float(np.concatenate(equal_rows).mean())
        say(f"requests: submit x4, /search_raw (136 queries), /search (2): "
            f"{share:.4f} of rows equal to a direct search")
        check(share >= 0.99, "served rows differ from a direct search")
        out = _main_path(svc, label, query, gt, counters, timed)
        if trace:
            out["trace"] = traced(
                lambda: svc.submit(query, None, 10, timeout=600),
                TRACE_DIR / "request", TRACE_REQUESTS, f"{label} request")
    finally:
        httpd.shutdown()   # serve() returns, closes the socket, stops svc
        server.join(30)
    check(not server.is_alive(), "HTTP server thread did not stop")
    check(not svc._dispatcher.is_alive() and not svc._completer.is_alive(),
          "service threads did not stop")
    return out


def _main_path(svc, label: str, query, gt, counters: dict,
               timed: int) -> dict:
    """All queries through ``svc`` as one request, launch counts from 0;
    then ``timed`` requests on the host clock (the host is shared, so the
    median and the quartiles are reported)."""
    import numpy as np

    from gbnns_tpu_torch.eval.recall import recall_at_k

    for module in counters:
        module.reset_launches()
    t0 = time.perf_counter()
    ids, _ = svc.submit(query, None, 10, timeout=600)
    first_s = time.perf_counter() - t0
    counts = {name: module.launches[name]
              for module, names in counters.items() for name in names}
    by_cores = {k: v for module in counters
                for k, v in getattr(module, "launches_by_cores", {}).items()}
    r1 = recall_at_k(ids, gt, 1)
    r10 = recall_at_k(ids, gt, 10)
    check(ids.shape == (query.shape[0], 10) and ids.min() >= 0
          and ids.max() < svc.flat.base_full.shape[0],
          "result ids out of range")
    batch_s = []
    for _ in range(timed):
        t0 = time.perf_counter()
        svc.submit(query, None, 10, timeout=600)
        batch_s.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(batch_s, [25, 50, 75])
    qps = query.shape[0] / med
    say(f"{label}: R@1={r1:.4f} R@10={r10:.4f} QPS={qps:,.0f} (median of "
        f"{timed} requests of {query.shape[0]} queries; request ms "
        f"quartiles {q1 * 1e3:.2f} / {med * 1e3:.2f} / {q3 * 1e3:.2f}, min "
        f"{min(batch_s) * 1e3:.2f}, max {max(batch_s) * 1e3:.2f}; first "
        f"request {first_s:.3f} s) launches {counts}")
    out = {"engine": label, "r1": r1, "r10": r10, "qps": qps,
           "batch_ms": [t * 1e3 for t in batch_s], "nq": query.shape[0],
           "launches": counts, "launches_by_cores": by_cores}
    say(json.dumps(out))
    return out


def trace_breakdown(events: list, wall_s: list) -> dict:
    """Where ``len(wall_s)`` requests' time went, from the events of their
    profiler trace: device time by stage (a kernel or copy belongs to the
    innermost named range, ``serve.*`` or ``fused.rerank``, whose thread
    launched it, found through the launch's correlation id; K1 and K2 by
    their names), the host spans of those ranges, and how much of the
    requests' wall time the device was busy (the union of its intervals).
    Times are milliseconds a request."""
    n_req = len(wall_s)
    ranges = [e for e in events
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat", "").startswith("cuda_")
                and "correlation" in e.get("args", {})}
    work = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]

    def stage(ev) -> str:
        for tag, name in (("binned_scan", "K1 binned_scan"),
                          ("merge_topc", "K2 merge_topc")):
            if tag in ev["name"]:
                return name
        launch = launches.get(ev.get("args", {}).get("correlation"))
        if launch is None:
            return "unattributed"
        inner = [r for r in ranges if r.get("tid") == launch.get("tid")
                 and r["ts"] <= launch["ts"] <= r["ts"] + r["dur"]]
        return (min(inner, key=lambda r: r["dur"])["name"] if inner
                else "outside the named stages")

    device_ms: dict[str, float] = {}
    for ev in work:
        key = stage(ev)
        if ev.get("cat") == "gpu_memcpy":
            key += " (copy)"
        device_ms[key] = device_ms.get(key, 0.0) + ev["dur"] / 1e3 / n_req
    busy, end = 0.0, None
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in work):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    host_ms: dict[str, float] = {}
    for r in ranges:
        host_ms[r["name"]] = host_ms.get(r["name"], 0.0) + r["dur"] / 1e3 / n_req
    wall_ms = sum(wall_s) * 1e3 / n_req
    busy_ms = busy / 1e3 / n_req
    return {"requests": n_req, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_ms": dict(sorted(device_ms.items(),
                                     key=lambda kv: -kv[1])),
            "host_span_ms": host_ms}


def traced(fn, out_dir: pathlib.Path, calls: int, label: str) -> dict:
    """``calls`` calls of ``fn`` (each waited for) under
    ``eval.trace.profile_trace``, the Chrome trace written to ``out_dir``,
    and their breakdown (``trace_breakdown``)."""
    import torch

    from gbnns_tpu_torch.eval.trace import TRACE_FILE, profile_trace

    wall_s = []
    with profile_trace(str(out_dir)):
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s.append(time.perf_counter() - t0)
    with open(out_dir / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    out = trace_breakdown(events, wall_s)
    check(out["device_busy_ms"] > 0, f"the {label} trace holds no device "
          f"work")
    say(f"{label} trace ({out_dir / TRACE_FILE}): {json.dumps(out)}")
    return out


def serve_fused(dtype, base, query, base_lo, gt, trained, device, records,
                targets: bool, timed: int) -> dict:
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.kernels import scan_topk as st
    from gbnns_tpu_torch.serve import SearchService

    c = REFERENCE[dtype]["c"]
    t0 = time.perf_counter()
    svc = SearchService(base, base_lo, engine="fused", c=c,
                        projection=projector(trained), scan_dtype=dtype,
                        max_batch=4096, device=device)
    say(f"SearchService(fused, {dtype}, c={c}) up: "
        f"{time.perf_counter() - t0:.2f} s")

    def direct(rows):
        q = torch.from_numpy(rows).to(device)
        return svc.fused.search(q, projector(trained)(q), k=10,
                                c=c)[0].cpu().numpy()

    trace = dtype == "bfloat16" and device.type == "cuda"
    out = _serve(svc, f"fused {dtype} c={c}", query, gt, direct,
                 {st: ("binned_scan", "merge_topc")}, timed,
                 trace=trace)
    counts = out["launches"]
    records.setdefault(f"binned_scan[{dtype}]", {})["launches"] = \
        counts["binned_scan"]
    records.setdefault(f"merge_topc[{dtype},c={c}]", {})["launches"] = \
        counts["merge_topc"]
    if device.type == "cuda":
        check(counts["binned_scan"] > 0 and counts["merge_topc"] > 0,
              f"the {dtype} serving run launched no kernel: {counts}")
        check(counts["merge_topc"] == counts["binned_scan"],
              f"the {dtype} serving run launched K2 more than once a "
              f"scan: {counts}")
    x = svc.fused.x_lo
    main_path_route(records, f"binned_scan[{dtype}]", "binned_scan",
                    st.scan_cores(x.dtype, x.shape[1], svc.fused.bin_size),
                    {c: out["launches_by_cores"][f"binned_scan:{c}"]
                     for c in ("tensor", "cuda")}, device,
                    f"serve fused {dtype}")
    if targets:
        ref = REFERENCE[dtype]["r10"]
        check(abs(out["r10"] - ref) <= R10_TOL,
              f"R@10 {out['r10']:.4f} is not within {R10_TOL} of the "
              f"reference {ref}")
    return out


def _shifted_check(st, idx, qlo, label: str) -> dict:
    """T3 on the operands ``idx.search`` gives it for ``qlo``, against its
    plain version: values within SCAN_RTOL plus one key quantum, ids equal
    except at counted near-ties."""
    import torch

    q_aug = idx.shifted_queries(qlo)
    kw = dict(bin_size=idx.bin_size)
    got = st.shifted_scan(q_aug, idx.x_aug, **kw)
    ref = st.shifted_scan_plain(q_aug, idx.x_aug, **kw)
    torch.cuda.synchronize()
    rep = st.shifted_agreement(got, ref, q_aug, idx.x_aug, rtol=SCAN_RTOL,
                               **kw)
    say(f"T3 shifted_scan[{label}] vs plain (B={q_aug.shape[0]}): {rep}")
    check(rep["ok"], f"T3 {label} disagrees with its plain version")
    return rep


def shifted_fused(base, query, base_lo, gt, trained, device, records,
                  binned_r10: float, targets: bool, timed: int) -> dict:
    """FusedScanIndex(mode="shifted") in bf16: its build, one search of all
    projected queries at c = 12 with the launch counts set to 0 before and
    read after, R@10 beside the same run's binned bf16, and timed searches;
    on the card T3 against its plain version at the serving shape and in
    fp16 and f32, with its record."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.kernels import scan_topk as st

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    c = REFERENCE["bfloat16"]["c"]
    t0 = time.perf_counter()
    idx = st.FusedScanIndex(base, base_lo, mode="shifted",
                            scan_dtype="bfloat16", device=device)
    sync()
    width = idx.x_aug.shape[1]
    say(f"FusedScanIndex(shifted, bf16): {time.perf_counter() - t0:.2f} s; "
        f"the kernel takes d_aug = {width} (d' = {idx.d_lo} + 4, no "
        f"padding), x_aug {tuple(idx.x_aug.shape)}")
    qf = torch.from_numpy(query).to(device)
    ql = projector(trained)(qf)
    st.reset_launches()
    ids = idx.search(qf, ql, k=10, c=c)[0].cpu().numpy()
    counts = {name: st.launches[name] for name in ("shifted_scan",
                                                   "merge_topc")}
    by_cores = route_counts(st, "shifted_scan")
    r1, r10 = recall_at_k(ids, gt, 1), recall_at_k(ids, gt, 10)
    check(ids.shape == (query.shape[0], 10) and ids.min() >= 0
          and ids.max() < base.shape[0], "shifted result ids out of range")
    batch_s = []
    for _ in range(timed):
        sync()
        t0 = time.perf_counter()
        idx.search(qf, ql, k=10, c=c)
        sync()
        batch_s.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(batch_s, [25, 50, 75])
    out = {"engine": f"fused shifted bfloat16 c={c}", "r1": r1, "r10": r10,
           "qps": query.shape[0] / med,
           "search_ms": [t * 1e3 for t in batch_s], "launches": counts}
    say(f"fused shifted c={c}: R@1={r1:.4f} R@10={r10:.4f} (binned bf16 of "
        f"this run {binned_r10:.4f}), {med * 1e3:.2f} ms a search of "
        f"{query.shape[0]} projected queries (median of {timed}; quartiles "
        f"{q1 * 1e3:.2f} / {q3 * 1e3:.2f}), QPS={out['qps']:,.0f}, "
        f"launches {counts}")
    say(json.dumps(out))
    records.setdefault("shifted_scan", {})["launches"] = counts["shifted_scan"]
    if device.type == "cuda":
        check(counts == {"shifted_scan": 1, "merge_topc": 0},
              f"a shifted search launched {counts}, not one T3 and no K2")
    main_path_route(records, "shifted_scan", "shifted_scan",
                    st.shifted_cores(idx.x_aug.dtype, width, idx.bin_size),
                    by_cores, device, "fused shifted")
    if targets:
        check(abs(r10 - binned_r10) <= R10_TOL,
              f"shifted R@10 {r10:.4f} is not within {R10_TOL} of the binned "
              f"bf16 {binned_r10:.4f}")
    if device.type == "cuda":
        shifted_kernel_check(st, idx, ql, base, base_lo, device, records)
    del idx
    sync()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def shifted_kernel_check(st, idx, ql, base, base_lo, device, records):
    """T3 against its plain version at the serving shape (bf16) and at
    B = SHIFTED_KIND_B in fp16 and f32; its record: T3 ms (median of five),
    the CUDA-core kernel's on the same inputs (``earlier_ms``: the only
    route before the tensor-core redesign), bound (2·B·n_pad·d_aug at the
    TPU kernel's d_aug, bf16 rate), plain ms and a bf16 torch.matmul of the
    same augmented operands."""
    import torch

    rep = _shifted_check(st, idx, ql, "bfloat16")
    q_aug = idx.shifted_queries(ql).to(torch.bfloat16)
    kw = dict(bin_size=idx.bin_size)
    ms = median_ms(lambda: st.shifted_scan(q_aug, idx.x_aug, **kw))
    cores = st.shifted_cores(idx.x_aug.dtype, q_aug.shape[1], idx.bin_size)
    earlier_ms = (ms if cores == "cuda" else median_ms(
        lambda: st.shifted_scan(q_aug, idx.x_aug, **kw, cores="cuda")))
    plain_ms = time_ms(lambda: st.shifted_scan_plain(q_aug, idx.x_aug, **kw),
                       2)
    lib_ms = time_ms(lambda: torch.matmul(idx.x_aug, q_aug.T), 3)
    torch.cuda.empty_cache()
    B, width = q_aug.shape
    n_pad = idx.x_aug.shape[0]
    d_aug = idx.d_lo + 4        # the TPU kernel's work, not a padded width
    n_bins = n_pad // idx.bin_size
    b_ms, b_by = bound_ms(B * width * 2 + n_pad * width * 2 + n_bins * B * 8,
                          2.0 * B * n_pad * d_aug, "bfloat16")
    say(f"T3 [B={B} n_pad={n_pad} d_aug={width}] on the {cores} cores: "
        f"{ms:.3f} ms (median of 5; CUDA-core kernel {earlier_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms, "
        f"torch.matmul of the augmented bf16 operands {lib_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    records["shifted_scan"] = {
        **dict(name="shifted_scan", route="cuda", source=SHIFTED_SOURCE,
               replaces=REPLACES["shifted_scan"], launches=None,
               max_abs_err=rep["max_abs_err"], ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, cores=cores,
               earlier_ms=earlier_ms),
        **records.get("shifted_scan", {})}
    for dtype in ("float16", "float32"):
        kind = st.FusedScanIndex(base, base_lo, mode="shifted",
                                 scan_dtype=dtype, device=device)
        _shifted_check(st, kind, ql[:SHIFTED_KIND_B], dtype)
        del kind
        torch.cuda.empty_cache()


def _gated_operands(idx, ql, probes: int):
    """T4's operands and options as ``idx.search`` gives them at
    ``probes``, and the least time the card could take for them: the
    operations of the kept cells, or each input read once (the chunks some
    tile keeps, their addvec, the queries and the mask) and each output
    written once. Returns (args, kw, bound_ms, bound_by, kept cells, cells,
    needed chunks)."""
    order, tile_mask, tq = idx.plan(ql, probes=probes)
    q_scan = idx.scan_queries(ql, order)
    args = (q_scan, idx.x_lo, idx.addvec, tile_mask)
    kw = dict(fine=idx.fine, m=idx.m, sub=idx.sub, chunk=idx.chunk, tq=tq)
    B, d = q_scan.shape
    el = idx.x_lo.element_size()
    keep = tile_mask.view(idx.n_chunks, B // tq) > 0
    cells = int(keep.sum())
    chunks = int(keep.any(dim=1).sum())
    n_bytes = (chunks * idx.chunk * (d * el + 4) + B * d * el
               + tile_mask.numel() * 4 + B * idx.m * idx.n_chunks * 8)
    b_ms, b_by = bound_ms(n_bytes, 2.0 * cells * tq * idx.chunk * d,
                          str(idx.x_lo.dtype).removeprefix("torch."))
    return args, kw, b_ms, b_by, cells, keep.numel(), chunks


def gated_check(idx, ql, records) -> None:
    """T4 against its plain version on all queries planned at probes 16, on
    the route ``gated_cores`` gives it (the launch is counted there) and on
    the CUDA cores, with its time, the CUDA-core kernel's on the same
    operands (``earlier_ms``, its error ``earlier_max_abs_err``),
    the plain version's, its bound from this run's kept cells and the full
    bf16 matmul at this shape as a yardstick."""
    import torch

    from gbnns_tpu_torch.kernels import scan_topk as st

    args, kw, b_ms, b_by, cells, n_cells, chunks = _gated_operands(idx, ql,
                                                                   16)
    q_scan = args[0]
    cores = st.gated_cores(idx.x_lo.dtype, q_scan.shape[1], fine=idx.fine,
                           tq=kw["tq"])
    before = route_counts(st, "gated_topm")[cores]
    got = st.gated_topm_scan(*args, **kw)
    ref = st.gated_topm_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    if q_scan.device.type == "cuda":
        check(route_counts(st, "gated_topm")[cores] == before + 1,
              f"T4 did not launch on the {cores} cores")
    rep = st.gated_agreement(got, ref, *args[:3], fine=idx.fine, sub=idx.sub,
                             chunk=idx.chunk, rtol=SCAN_RTOL)
    say(f"T4 gated_topm vs plain (probes 16) on the {cores} cores: {rep}")
    check(rep["ok"], "T4 disagrees with its plain version")
    earlier_rep = rep
    if cores != "cuda":     # the CUDA-core kernel, timed below, checked too
        got = st.gated_topm_scan(*args, **kw, cores="cuda")
        earlier_rep = st.gated_agreement(got, ref, *args[:3], fine=idx.fine,
                                         sub=idx.sub, chunk=idx.chunk,
                                         rtol=SCAN_RTOL)
        say(f"T4 gated_topm vs plain (probes 16) on the cuda cores: "
            f"{earlier_rep}")
        check(earlier_rep["ok"],
              "T4's CUDA-core kernel disagrees with its plain version")
    del got, ref
    ms = time_ms(lambda: st.gated_topm_scan(*args, **kw))
    earlier_ms = (ms if cores == "cuda" else time_ms(
        lambda: st.gated_topm_scan(*args, **kw, cores="cuda")))
    plain_ms = time_ms(lambda: st.gated_topm_scan_plain(*args, **kw), 2)
    yard_ms = time_ms(lambda: torch.matmul(idx.x_lo, q_scan.T), 3)
    torch.cuda.empty_cache()
    say(f"T4 [B={q_scan.shape[0]} n_pad={idx.x_lo.shape[0]} "
        f"d={q_scan.shape[1]} tq={kw['tq']}, kept {cells}/{n_cells} cells, "
        f"{chunks}/{idx.n_chunks} chunks] on the {cores} cores: {ms:.3f} ms "
        f"(CUDA-core kernel {earlier_ms:.3f} ms), plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); library: none (no PyTorch call "
        f"computes a gated top-m), yardstick: the full bf16 matmul at this "
        f"shape {yard_ms:.3f} ms")
    records["gated_topm"] = {
        **dict(name="gated_topm", route="cuda", source=GATED_SOURCE,
               replaces=REPLACES["gated_topm"], launches=None,
               max_abs_err=rep["max_abs_err"], ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               yardstick_ms=yard_ms, cores=cores, earlier_ms=earlier_ms,
               earlier_max_abs_err=earlier_rep["max_abs_err"]),
        **records.get("gated_topm", {})}


def gated_scan(base, query, base_lo, gt, trained, device, records,
               targets: bool, timed: int) -> list[dict]:
    """GatedScanIndex at its defaults: its build, T4 against its plain
    version, then the probes sweep at c = 32."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.kernels import scan_topk as st
    from gbnns_tpu_torch.search.gated import GatedScanIndex

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    idx = GatedScanIndex(base, base_lo, device=device)
    secs = ", ".join(f"{k} {v:.2f} s" for k, v in idx.build_seconds.items())
    say(f"GatedScanIndex: {time.perf_counter() - t0:.2f} s ({secs}); "
        f"stats {idx.stats}")
    qf = torch.from_numpy(query).to(device)
    ql = projector(trained)(qf)
    if device.type == "cuda":
        gated_check(idx, ql, records)
    tq = idx.plan(ql)[2]    # the plan's query tile: B's, whatever probes
    cores = st.gated_cores(idx.x_lo.dtype, idx.x_lo.shape[1], fine=idx.fine,
                           tq=tq)
    outs = []
    for probes in GATED_PROBES:
        st.reset_launches()
        ids, _, kept = idx.search(qf, ql, k=10, c=GATED_C, probes=probes,
                                  return_kept_frac=True)
        ids = ids.cpu().numpy()
        launches = st.launches["gated_topm"]
        # every search's T4 launch on the tensor cores; probes 16's counts
        # go into the record beside its launches
        main_path_route(records if probes == 16 else {}, "gated_topm",
                        "gated_topm", cores, route_counts(st, "gated_topm"),
                        device, f"gated probes={probes}")
        r1, r10 = recall_at_k(ids, gt, 1), recall_at_k(ids, gt, 10)
        check(ids.shape == (query.shape[0], 10) and ids.min() >= 0
              and ids.max() < base.shape[0], "gated result ids out of range")
        batch_s = []
        for _ in range(timed):
            sync()
            t0 = time.perf_counter()
            idx.search(qf, ql, k=10, c=GATED_C, probes=probes)
            sync()
            batch_s.append(time.perf_counter() - t0)
        med = float(np.median(batch_s))
        out = {"engine": f"gated probes={probes} c={GATED_C}", "r1": r1,
               "r10": r10, "kept_frac": kept, "qps": query.shape[0] / med,
               "search_ms": [t * 1e3 for t in batch_s],
               "launches": {"gated_topm": launches}}
        say(f"gated probes={probes} c={GATED_C}: R@1={r1:.4f} "
            f"R@10={r10:.4f} kept {kept:.4f} of cells, {med * 1e3:.2f} ms "
            f"a search of {query.shape[0]} projected queries (median of "
            f"{timed}), QPS={out['qps']:,.0f}, T4 launches {launches}")
        if device.type == "cuda":
            check(launches == 1, f"gated probes={probes} launched T4 "
                  f"{launches} times, not once")
            args, kw, b_ms, _, cells, n_cells, _ = _gated_operands(
                idx, ql, probes)
            out["t4_ms"] = time_ms(lambda: st.gated_topm_scan(*args, **kw))
            out["t4_earlier_ms"] = time_ms(
                lambda: st.gated_topm_scan(*args, **kw, cores="cuda"))
            out["t4_bound_ms"] = b_ms
            say(f"  T4 at probes={probes} ({cells}/{n_cells} cells) on the "
                f"{cores} cores: {out['t4_ms']:.3f} ms (CUDA-core kernel "
                f"{out['t4_earlier_ms']:.3f} ms), bound {b_ms:.4f} ms")
            del args
        if probes == 16:
            records.setdefault("gated_topm", {})["launches"] = launches
        say(json.dumps(out))
        outs.append(out)
    r = {o["engine"].split()[1]: o["r10"] for o in outs}
    say(f"gated R@10 by probes {r} (JAX package, TPU v5e with a PCA "
        f"projection, results/gated_1m.json: 0.9737 at probes 16)")
    if targets:
        r4, r16, r32 = r["probes=4"], r["probes=16"], r["probes=32"]
        check(r4 <= r16 + 0.02 <= r32 + 0.04,
              f"gated R@10 falls as probes grows: {r}")
        check(r32 >= GATED_R10_MIN,
              f"gated R@10 {r32:.4f} < {GATED_R10_MIN} at probes 32")
    del idx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return outs


def ivf_phase(base, query, base_lo, gt, trained, device, targets: bool,
              timed: int) -> list[dict]:
    """IVFIndex.build at its defaults (seed 0), then probes 8, 16, 32 at
    c = 32: R@1, R@10, QPS (median of ``timed`` synchronized searches) and
    the peak device memory of a search; one search under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises if it waits
    for the host."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.search.ivf import IVFIndex

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    idx = IVFIndex.build(base, base_lo, seed=0, device=device)
    sync()
    say(f"IVFIndex.build: {time.perf_counter() - t0:.2f} s, stats "
        f"{idx.stats} (JAX package on the TPU: spill {IVF_JAX_SPILL})")
    if targets:
        got = {k: idx.stats[k] for k in IVF_SHAPE}
        check(got == IVF_SHAPE, f"IVF shape {got}, not {IVF_SHAPE}")
    qf = torch.from_numpy(query).to(device)
    ql = projector(trained)(qf)
    outs = []
    for probes in sorted(IVF_R10):
        if cuda:
            sync()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        ids = idx.search(qf, ql, k=10, c=IVF_C, probes=probes)[0]
        ids = ids.cpu().numpy()
        peak = (torch.cuda.max_memory_allocated() - before) if cuda else None
        check(ids.shape == (query.shape[0], 10) and ids.min() >= 0
              and ids.max() < base.shape[0], "IVF result ids out of range")
        r1, r10 = recall_at_k(ids, gt, 1), recall_at_k(ids, gt, 10)
        batch_s = []
        for _ in range(timed):
            sync()
            t0 = time.perf_counter()
            idx.search(qf, ql, k=10, c=IVF_C, probes=probes)
            sync()
            batch_s.append(time.perf_counter() - t0)
        med = float(np.median(batch_s))
        out = {"engine": f"ivf probes={probes} c={IVF_C}", "r1": r1,
               "r10": r10, "qps": query.shape[0] / med,
               "search_ms": [t * 1e3 for t in batch_s],
               "peak_bytes": peak, "reference_r10": IVF_R10[probes]}
        say(f"ivf probes={probes} c={IVF_C}: R@1={r1:.4f} R@10={r10:.4f} "
            f"(JAX on the TPU {IVF_R10[probes]}), {med * 1e3:.2f} ms a "
            f"search of {query.shape[0]} projected queries (median of "
            f"{timed}), QPS={out['qps']:,.0f}, peak "
            f"{'not measured' if peak is None else f'{peak / 1e9:.2f} GB'}")
        say(json.dumps(out))
        outs.append(out)
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
        try:
            idx.search(qf, ql, k=10, c=IVF_C, probes=16)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync()
        say("ivf search under set_sync_debug_mode('error'): no host sync")
        traced(lambda: idx.search(qf, ql, k=10, c=IVF_C, probes=32),
               TRACE_DIR / "ivf", 1, f"ivf probes=32 c={IVF_C} search")
    r = [o["r10"] for o in outs]
    if targets:
        check(all(a <= b for a, b in zip(r, r[1:])),
              f"IVF R@10 falls as probes grows: {r}")
        for o, (probes, ref) in zip(outs, sorted(IVF_R10.items())):
            check(o["r10"] >= ref - R10_TOL, f"IVF R@10 {o['r10']:.4f} at "
                  f"probes {probes} is below the reference {ref} less "
                  f"{R10_TOL}")
    del idx
    if cuda:
        torch.cuda.empty_cache()
    return outs


def train_phase(base, query, gt, device, targets: bool,
                steps: int = TRAIN_STEPS) -> dict:
    """The port's trainer at bench.py's recipe
    (``gbnns_tpu_torch.bench.retrain_projection``: the subsample of
    ``default_rng(1)``, positives its exact in-sample neighbours, ``steps``
    steps of batch 1024, validation every max(50, steps // 4)); then a
    bf16 FusedScanIndex over the new projection answers all queries at
    c = 12."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.bench import retrain_projection
    from gbnns_tpu_torch.dimred.train import project, projector
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex

    trained, secs = retrain_projection(base, REDUCED_DIM, steps, device)
    hist = [float(v) for v in trained["val_history"]]
    say(f"train_projection ({secs['rows']} rows, {steps} steps): "
        f"{secs['train_s']:.2f} s (exact neighbours "
        f"{secs['neighbours_s']:.2f} s); val@{trained['cfg'].val_c} by step "
        f"{hist}, best step {trained['best_step']} "
        f"({trained['best_val']:.4f})")
    losses = trained["losses"]
    check(losses.shape == (steps,) and np.isfinite(losses).all(),
          "training losses are not all finite")
    check(trained["best_val"] >= hist[0],
          f"the selected val {trained['best_val']} is below step 0's "
          f"{hist[0]}")
    base_lo = project(trained, base)
    idx = FusedScanIndex(base, base_lo, device=device)
    qf = torch.from_numpy(query).to(device)
    ids = idx.search(qf, projector(trained)(qf), k=10,
                     c=REFERENCE["bfloat16"]["c"])[0].cpu().numpy()
    r1, r10 = recall_at_k(ids, gt, 1), recall_at_k(ids, gt, 10)
    out = {**secs, "val_history": hist, "best_step": trained["best_step"],
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "r1": r1, "r10": r10, "cached_r10": REFERENCE["bfloat16"]["r10"]}
    say(f"fused bf16 c={REFERENCE['bfloat16']['c']} over the trained "
        f"projection: R@1={r1:.4f} R@10={r10:.4f} (the cached projection: "
        f"{REFERENCE['bfloat16']['r10']})")
    say(json.dumps(out))
    if targets:
        check(r10 >= TRAIN_R10_MIN, f"R@10 {r10:.4f} over the trained "
              f"projection is below {TRAIN_R10_MIN}")
    del idx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def build_chunk_check(base_lo, device, records):
    """K1 packed and K2 at c = K + 1, as the fused build runs them, against
    their plain versions on the first node chunk of the build's operands."""
    import torch

    from gbnns_tpu_torch.build.knn_graph import fused_operands
    from gbnns_tpu_torch.kernels import scan_topk as st

    nodes, x, addvec, bin_size = fused_operands(base_lo, GRAPH_K,
                                                device=device)
    q = nodes[:BUILD_CHUNK].to(torch.bfloat16)
    del nodes
    got, rec = _scan_check(st, (q, x, addvec, None),
                           dict(bin_size=bin_size, packed=True),
                           "bfloat16,packed")
    # yardstick, as for the serving scan: the bare score product
    rec["library_ms"] = time_ms(lambda: torch.matmul(x, q.T), 3)
    torch.cuda.empty_cache()
    records[rec["name"]] = {**rec, **records.get(rec["name"], {})}
    rec = _merge_check(st, *got, GRAPH_K + 1, f"build,c={GRAPH_K + 1}")
    records[rec["name"]] = {**rec, **records.get(rec["name"], {})}
    del got, q, x, addvec
    torch.cuda.empty_cache()


def graph_build(base_lo, device, records, targets: bool):
    """The fused kNN-graph build on the projected corpus with its launch
    counts, its kernels at the build's settings against their plain
    versions, its reachability and its overlap with the exact build; then
    centroid entries and the bf16 hop payload."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.build.knn_graph import (build_knn_graph,
                                                 forward_reachable,
                                                 fused_bin_size)
    from gbnns_tpu_torch.kernels import scan_topk as st
    from gbnns_tpu_torch.kernels.scan_topk import scan_width
    from gbnns_tpu_torch.search.entries import CentroidEntries
    from gbnns_tpu_torch.search.walker import default_entry_ids
    from gbnns_tpu_torch.search.walker_payload import pack_hop_payload

    n = base_lo.shape[0]
    stats: dict = {}
    st.reset_launches()
    t0 = time.perf_counter()
    graph = build_knn_graph(base_lo, GRAPH_K, backend="fused", stats=stats,
                            node_chunk=BUILD_CHUNK, device=device)
    secs = time.perf_counter() - t0
    counts = {name: st.launches[name] for name in ("binned_scan",
                                                   "merge_topc")}
    by_cores = route_counts(st, "binned_scan")
    say(f"fused graph {graph.shape}: {secs:.2f} s (sweep "
        f"{stats['scan_s']:.2f} s, reverse edges {stats['reverse_s']:.2f} s, "
        f"ensure_connected {stats['connect_s']:.2f} s) launches {counts}")
    records.setdefault("binned_scan[bfloat16,packed]", {})["launches"] = \
        counts["binned_scan"]
    records.setdefault(f"merge_topc[build,c={GRAPH_K + 1}]", {})[
        "launches"] = counts["merge_topc"]
    if device.type == "cuda":
        check(counts["binned_scan"] > 0 and counts["merge_topc"] > 0,
              f"the fused build launched no kernel: {counts}")
        check(counts["merge_topc"] == counts["binned_scan"],
              f"the fused build launched K2 more than once a chunk: "
              f"{counts}")
    # the build scans bf16 at the kernel's width in bins of fused_bin_size
    main_path_route(records, "binned_scan[bfloat16,packed]", "binned_scan",
                    st.scan_cores(torch.bfloat16, scan_width(base_lo.shape[1]),
                                  fused_bin_size(n, GRAPH_K)),
                    by_cores, device, "graph build")
    if device.type == "cuda":
        build_chunk_check(base_lo, device, records)
    reached = forward_reachable(graph, np.asarray(default_entry_ids(n)))
    say(f"reachable from the walker's entries: {int(reached.sum())}/{n}")
    check(bool(reached.all()), "the graph is not fully reachable")
    t0 = time.perf_counter()
    stats = {}
    exact = build_knn_graph(base_lo, GRAPH_K, backend="xla", stats=stats,
                            device=device)
    say(f"exact graph: {time.perf_counter() - t0:.2f} s (sweep "
        f"{stats['scan_s']:.2f} s, reverse edges {stats['reverse_s']:.2f} s, "
        f"ensure_connected {stats['connect_s']:.2f} s)")
    rows = np.random.default_rng(0).choice(n, min(1024, n), replace=False)
    overlap = float(np.mean([np.intersect1d(graph[r], exact[r]).size
                             for r in rows]) / GRAPH_K)
    say(f"edge overlap with the exact build on {rows.size} nodes: "
        f"{overlap:.4f} (JAX package on these inputs: 0.7874)")
    if targets:
        check(overlap >= OVERLAP_MIN,
              f"overlap {overlap:.4f} < {OVERLAP_MIN:.4f}")
    del exact
    t0 = time.perf_counter()
    entries = CentroidEntries.build(base_lo, ncent=n // 256, device=device)
    say(f"CentroidEntries ({n // 256} centroids): "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    payload = pack_hop_payload(graph, base_lo, vec_dtype="bfloat16",
                               device=device)
    say(f"bf16 hop payload: {payload.words * 4} B rows, "
        f"{payload.data.numel() * 4 / 1e9:.3f} GB, "
        f"{time.perf_counter() - t0:.2f} s")
    return graph, entries, payload


def exact_knn(base_lo, device, records) -> None:
    """T6 knn_topk on the graph build's shape: the first KNN_Q rows of the
    projected corpus against all of it, k = K + 1, l2, f32, with the launch
    count set to 0 before and read after; held against knn_chunked (the
    exact sweep of the xla build) and, on KNN_SLICE queries, against its
    plain version, in l2, ip and bf16; its record, with knn_chunked's time
    as the yardstick and an fp32 torch.matmul of the same shape beside it."""
    import torch

    from gbnns_tpu_torch.kernels import distance_topk as dt
    from gbnns_tpu_torch.kernels.topk import knn_chunked

    x = torch.from_numpy(base_lo).to(device)
    q = x[:KNN_Q]
    nq, n, d = q.shape[0], x.shape[0], x.shape[1]
    dt.reset_launches()
    got = dt.knn_topk(q, x, KNN_K)
    launches = dt.launches["knn_topk"]
    records.setdefault("knn_topk", {})["launches"] = launches
    say(f"knn_topk of {nq} x {n} x {d}, k={KNN_K}: launches {launches}")
    if device.type == "cuda":
        check(launches == 1, f"knn_topk launched T6 {launches} times")
    check(tuple(got[1].shape) == (nq, KNN_K) and bool(torch.isfinite(
        got[0]).all()) and int(got[1].min()) >= 0 and int(got[1].max()) < n,
        "knn_topk result malformed")
    ref = knn_chunked(q, x, KNN_K)
    rep = dt.knn_agreement(got, ref, q, x)
    say(f"T6 knn_topk vs knn_chunked ({nq} queries): {rep}")
    check(rep["ok"], "T6 disagrees with knn_chunked")
    del ref
    qs = q[:KNN_SLICE]
    for label, args, kw in (
            ("l2", (qs, x), {}), ("ip", (qs, x), dict(metric="ip")),
            ("bf16", (qs.to(torch.bfloat16), x.to(torch.bfloat16)), {})):
        part = dt.knn_topk(*args, KNN_K, **kw)
        plain = dt.knn_topk_plain(*args, KNN_K, **kw)
        r = dt.knn_agreement(part, plain, *args, **kw)
        say(f"T6 knn_topk[{label}] vs plain ({qs.shape[0]} queries): {r}")
        check(r["ok"], f"T6 ({label}) disagrees with its plain version")
        if label == "l2":
            max_err = max(r["max_abs_err"], rep["max_abs_err"])
    if device.type == "cuda":
        knn_record(q, x, max_err, records)


def knn_record(q, x, max_err: float, records) -> None:
    """T6's record on ``q`` against ``x``: its time, its plain version's,
    its bound (fp32 operations), knn_chunked's time as the yardstick and an
    fp32 torch.matmul of the same shape beside it."""
    import torch

    from gbnns_tpu_torch.kernels import distance_topk as dt
    from gbnns_tpu_torch.kernels.distance import exact_fp32
    from gbnns_tpu_torch.kernels.topk import knn_chunked

    nq, n, d = q.shape[0], x.shape[0], x.shape[1]
    ms = time_ms(lambda: dt.knn_topk(q, x, KNN_K))
    plain_ms = time_ms(lambda: dt.knn_topk_plain(q, x, KNN_K), 2)
    yard_ms = time_ms(lambda: knn_chunked(q, x, KNN_K), 2)
    chunk = 65536   # knn_chunked's: the (nq, n) product takes 33 GB at once

    def matmul():
        with exact_fp32():
            for off in range(0, n, chunk):
                torch.matmul(q, x[off:off + chunk].T)

    mm_ms = time_ms(matmul, 2)
    torch.cuda.empty_cache()
    b_ms, b_by = bound_ms(nq * d * 4 + n * d * 4 + nq * KNN_K * 8,
                          2.0 * nq * n * d, "float32")
    say(f"T6 [{nq} x {n} x {d}, k={KNN_K}]: {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); library: none (no "
        f"single PyTorch call computes an exact k-NN), yardstick knn_chunked "
        f"{yard_ms:.3f} ms, fp32 torch.matmul of the same shape in "
        f"{-(-n // chunk)} chunks of {chunk} rows {mm_ms:.3f} ms")
    records["knn_topk"] = {
        **dict(name="knn_topk", route="cuda", source=KNN_SOURCE,
               replaces=REPLACES["knn_topk"], launches=None,
               max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               yardstick_ms=yard_ms, matmul_ms=mm_ms),
        **records.get("knn_topk", {})}


def walker_checks(graph, entries, payload, base_lo, query, trained, device):
    """1,024 queries: the walk with K3 against the same walk with the plain
    gather, and the f32-payload walk against the plain walker: identical."""
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.kernels import gather
    from gbnns_tpu_torch.search.walker import beam_search
    from gbnns_tpu_torch.search.walker_payload import (beam_search_payload,
                                                       pack_hop_payload)

    q = projector(trained)(torch.from_numpy(query[:1024]).to(device))
    ent = entries.query_entries(q, 16)
    lo = torch.from_numpy(base_lo).to(device)

    def same(a, b):
        return (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
                and torch.equal(a.n_dist, b.n_dist) and a.hops == b.hops)

    kw = dict(ef=48, max_hops=64)
    k3 = beam_search_payload(q, payload, lo, ent, **kw)
    plain = beam_search_payload(q, payload, lo, ent,
                                gather=gather.row_gather_plain, **kw)
    say(f"walker bf16, K3 vs plain gather: identical {same(k3, plain)} "
        f"({k3.hops} hops, {k3.n_dist.float().mean().item():.1f} distances "
        f"a query)")
    check(same(k3, plain), "the K3 walk differs from the plain-gather walk")
    p32 = pack_hop_payload(graph, base_lo, vec_dtype="float32", device=device)
    a = beam_search_payload(q, p32, lo, ent, **kw)
    b = beam_search(q, lo, torch.from_numpy(graph).to(device), ent, **kw)
    say(f"walker f32 payload vs beam_search: identical {same(a, b)} "
        f"({a.hops} hops)")
    check(same(a, b), "the f32-payload walk differs from beam_search")
    del p32
    if device.type == "cuda":
        torch.cuda.empty_cache()


def hop_breakdown(svc, query, trained, device, ef: int = 48) -> dict:
    """Where a graph request's time goes: the device time of each stage of
    one hop (CUDA events, each stage alone, 20 runs) on a pool taken from a
    real walk of all queries, stopped after 8 hops with the first half of
    every pool marked expanded; and the stages around the walk."""
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.kernels.gather import row_gather
    from gbnns_tpu_torch.kernels.distance import squared_norms
    from gbnns_tpu_torch.search.rerank import rerank
    from gbnns_tpu_torch.search.walker import (_dedup, merge_pool,
                                               select_frontier)
    from gbnns_tpu_torch.search.walker_payload import (_hop_dists,
                                                       beam_search_payload)

    gidx = svc.gidx
    pay = gidx.payload
    qf = torch.from_numpy(query).to(device)
    ql = projector(trained)(qf)
    B, M, K = ql.shape[0], 4, pay.K
    ent = gidx.entries.query_entries(ql, 16)
    res = beam_search_payload(ql, pay, gidx.base_lo, ent, ef=ef, max_hops=8)
    beam_ids, beam_d = res.ids, res.dists
    expanded = (torch.arange(ef, device=device) < ef // 2).expand(B, ef)
    q_sq = squared_norms(ql)
    f_ids, live, _ = select_frontier(beam_ids, expanded, M)
    raw = row_gather(pay.data, f_ids.reshape(-1), check_ids=False)
    dist, nbrs = _hop_dists(raw, ql, q_sq, B=B, M=M, K=K, d=pay.d,
                            vec_words=pay.vec_words, bf16=pay.bf16,
                            metric="l2")

    def dedup():   # the walk's own step, beam visited mode
        return _dedup(nbrs, dist, beam_ids, M=M, intra_dedup=True)

    invalid, cand_d = dedup()
    stages = {
        "frontier (cumsum + stable sort)":
            lambda: select_frontier(beam_ids, expanded, M),
        "K3 gather": lambda: row_gather(pay.data, f_ids.reshape(-1),
                                        check_ids=False),
        "hop distances (decode + bmm)": lambda: _hop_dists(
            raw, ql, q_sq, B=B, M=M, K=K, d=pay.d, vec_words=pay.vec_words,
            bf16=pay.bf16, metric="l2"),
        "dedup (pool compare + sort)": dedup,
        "merge (stable sort + gathers)": lambda: merge_pool(
            beam_ids, beam_d, expanded, nbrs, cand_d, invalid, ef),
        "host sync (one flag)": lambda: bool((~expanded).any()),
    }
    out = {name: time_ms(fn, 20) for name, fn in stages.items()}
    hop = sum(out.values())
    for name, ms in out.items():
        say(f"  hop stage {name}: {ms:.4f} ms ({ms / hop:.0%})")
    around = {
        "projection": lambda: projector(trained)(qf),
        "centroid entries": lambda: gidx.entries.query_entries(ql, 16),
        "re-rank": lambda: rerank(qf, gidx.base_full, beam_ids, 10,
                                  base_sqnorms=gidx.base_sq),
    }
    for name, fn in around.items():
        out[name] = time_ms(fn, 10)
        say(f"  request stage {name}: {out[name]:.4f} ms")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    walk = beam_search_payload(ql, pay, gidx.base_lo, ent, ef=ef,
                               max_hops=64)
    sync()
    out["walk_ms"] = (time.perf_counter() - t0) * 1e3
    out["hops"] = walk.hops
    say(f"walk of {B} queries at ef={ef}: {out['walk_ms']:.2f} ms over "
        f"{walk.hops} hops = {out['walk_ms'] / walk.hops:.3f} ms a hop "
        f"(host clock); the stages alone sum to {hop:.3f} ms")
    return out


def serve_graph(base, query, base_lo, gt, trained, graph, entries, device,
                records, targets: bool, timed: int) -> list[dict]:
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.kernels import gather
    from gbnns_tpu_torch.serve import SearchService

    with tempfile.TemporaryDirectory() as tmp:
        cents = os.path.join(tmp, "centroids.npz")
        entries.save(cents)   # the staged quantizer, as `serve --centroids`
        t0 = time.perf_counter()
        svc = SearchService(base, base_lo, graph, engine="graph_pallas",
                            ef=GRAPH_EFS[0], projection=projector(trained),
                            centroids_path=cents, max_batch=4096,
                            device=device)
    say(f"SearchService(graph_pallas) up: {time.perf_counter() - t0:.2f} s")

    def direct(rows):
        q = torch.from_numpy(rows).to(device)
        return svc.gidx.search(q, projector(trained)(q), k=10, ef=svc.ef,
                               num_entries=min(16, svc.ef))[0].cpu().numpy()

    if device.type == "cuda":
        hop_breakdown(svc, query, trained, device)
    counters = {gather: ("row_gather",)}
    outs = []
    for i, ef in enumerate(GRAPH_EFS):
        svc.ef = ef   # read by every search
        label = f"graph_pallas ef={ef}"
        if i + 1 < len(GRAPH_EFS):
            outs.append(_main_path(svc, label, query, gt, counters, timed))
        else:   # the last ef also answers HTTP, then stops the service
            outs.append(_serve(svc, label, query, gt, direct, counters,
                               timed))
        launches = outs[-1]["launches"]["row_gather"]
        say(f"{label}: K3 launches per request {launches} (one per hop)")
        if device.type == "cuda":
            check(launches > 0, f"{label} launched no K3")
        if ef == 48:
            records.setdefault("row_gather", {})["launches"] = launches
    r10 = [o["r10"] for o in outs]
    if targets:
        check(r10[-1] >= GRAPH_R10_MIN,
              f"graph R@10 {r10[-1]:.4f} < {GRAPH_R10_MIN} at ef={GRAPH_EFS[-1]}")
        check(all(b >= a for a, b in zip(r10, r10[1:])),
              f"graph R@10 falls as ef grows: {r10}")
    return outs


def pipeline_phase(graph, base_lo, device, records, targets: bool,
                   out_dir: pathlib.Path, scale: float,
                   steps: int | None) -> dict:
    """The experiment driver at full width: run_pipeline on
    configs/sift1m_dr32.json (at ``scale`` of its 1M rows; ``steps``
    trainer steps where given, else the config's 2,000), writing to
    ``out_dir``, with K3's launches counted from 0 before the run and read
    after; then K3 against its plain version on rows of the walker's f32
    payload shape (K 32, d 32), packed from the contract graph."""
    import numpy as np

    from gbnns_tpu_torch.config import ExperimentConfig
    from gbnns_tpu_torch.kernels import gather
    from gbnns_tpu_torch.pipeline import run_pipeline
    from gbnns_tpu_torch.search.walker_payload import pack_hop_payload

    cfg = ExperimentConfig.load(str(PIPELINE_CONFIG), out_dir=str(out_dir),
                                scale=scale)
    if steps is not None:
        cfg.dimred.steps = steps
        cfg.dimred.eval_every = max(1, steps // 4)
    check(pathlib.Path(cfg.out_dir).resolve() != ROOT / "results",
          "the pipeline phase must not write into results/")
    gather.reset_launches()
    t0 = time.perf_counter()
    out = run_pipeline(cfg, device=device)
    secs = time.perf_counter() - t0
    launches = gather.launches["row_gather"]
    s = out["summary"]
    trained = out["artifacts"]["trained"]
    say(f"run_pipeline({cfg.name}): {secs:.2f} s; dataset {cfg.dataset} "
        f"[{out['source']}] base ({s['n_base']}, {s['dim']}), "
        f"{s['results'][0]['n_queries']} queries; stage seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["stage_s"].items())
        + f"; projection {s['method']} {s['dim']}->{s['d_out']}, trained "
        f"{len(trained['losses'])} steps, best step "
        f"{trained.get('best_step')}; graph {out['graph'].shape} built in "
        f"{s['build_time_s']:.2f} s; K3 launches {launches}")
    r10 = []
    for r in s["results"]:
        say(f"pipeline {cfg.name} ef={r['ef']}: R@1={r['recall_at_1']:.4f} "
            f"R@10={r['recall_at_10']:.4f} QPS={r['qps']:,.0f} (pipelined, "
            f"{r['n_queries']} queries a batch) latency "
            f"{r['latency_ms']:.2f} ms dist/q={r['dist_comps_per_query']:.1f} "
            f"hops={r['hops']} walker={r['extra']['walker']}")
        r10.append(r["recall_at_10"])
    check(all(np.isfinite(r10)) and len(r10) == len(cfg.search.efs),
          f"pipeline results malformed: {r10}")
    records.setdefault("row_gather[f32]", {})["launches"] = launches
    if device.type == "cuda":
        check(launches > 0, "the pipeline's walk launched no K3")
    if targets:
        at = dict(zip(cfg.search.efs, r10))
        check(at[PIPELINE_GATE_EF] >= GRAPH_R10_MIN,
              f"pipeline R@10 {at[PIPELINE_GATE_EF]:.4f} < {GRAPH_R10_MIN} "
              f"at ef={PIPELINE_GATE_EF}")
        check(all(b >= a for a, b in zip(r10, r10[1:])),
              f"pipeline R@10 falls as ef grows: {r10}")
    if device.type == "cuda":
        payload = pack_hop_payload(graph, base_lo, vec_dtype="float32",
                                   device=device)
        # a hop gathers expand (4) rows a query
        gather_check(payload, 4 * s["results"][0]["n_queries"], device,
                     records, name="row_gather[f32]")
        del payload
    return out


def sharded_phase(base, query, base_lo, gt, trained, device, records,
                  targets: bool, timed: int) -> None:
    """The sharded engine over SHARDS shards that all lie on this one card:
    fused bf16 and int8 (no graph), then graph_pallas (per-shard graphs,
    payloads and centroid entries), each at ef SHARDED_EF over every query
    with the launch counts set to 0 before and read after; one shard's K1
    and K2 against their plain versions. The times measure the per-shard
    kernels and the merge on one card, not the speed of several cards."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.dimred.train import project
    from gbnns_tpu_torch.eval.bench import block_until_ready
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.kernels import gather
    from gbnns_tpu_torch.kernels import scan_topk as st
    from gbnns_tpu_torch.search import sharded as sh

    note = f"{SHARDS} shards on one card"
    mesh = sh.make_mesh(SHARDS, device=device)
    qlo = project(trained, query)

    def run(idx, engine, label, counters, **kw):
        def search():
            return sh.sharded_search(idx, qlo, 10, ef=SHARDED_EF,
                                     engine=engine, queries_full=query, **kw)
        for module in counters:
            module.reset_launches()
        ids, dists = search()
        ids = ids.cpu().numpy()
        counts = {name: module.launches[name]
                  for module, names in counters.items() for name in names}
        by_cores = route_counts(st, "binned_scan")
        check(ids.shape == (query.shape[0], 10) and ids.min() >= 0
              and ids.max() < base.shape[0]
              and bool(torch.isfinite(dists).all()),
              f"sharded {label}: results out of range")
        r1, r10 = recall_at_k(ids, gt, 1), recall_at_k(ids, gt, 10)
        secs = []
        for _ in range(min(timed, 5)):
            t0 = time.perf_counter()
            block_until_ready(search())
            secs.append(time.perf_counter() - t0)
        med = float(np.median(secs))
        say(f"sharded {label} ef={SHARDED_EF} ({note}): R@1={r1:.4f} "
            f"R@10={r10:.4f}, {med * 1e3:.2f} ms a search of "
            f"{query.shape[0]} queries (median of {len(secs)}, host clock, "
            f"synchronized; QPS {query.shape[0] / med:,.0f}) launches "
            f"{counts}")
        if targets:
            check(r10 >= SHARDED_R10_MIN,
                  f"sharded {label} R@10 {r10:.4f} < {SHARDED_R10_MIN}")
        return counts, by_cores

    t0 = time.perf_counter()
    idx = sh.build_sharded_index(base, GRAPH_K, mesh, base_lo=base_lo,
                                 with_graph=False)
    f_chunk, f_bin, f_pad = sh.fused_geometry(idx.n_shard, SHARDED_EF)
    say(f"sharded scan index ({note}, {SHARDS} x {idx.n_shard} rows): "
        f"{time.perf_counter() - t0:.2f} s; per-shard scan {f_pad} rows in "
        f"bins of {f_bin} (chunk {f_chunk})")
    for dtype in ("bfloat16", "int8"):
        counts, by_cores = run(idx, "fused", f"fused {dtype}",
                               {st: ("binned_scan", "merge_topc")},
                               scan_dtype=dtype)
        k1 = f"binned_scan[sharded,{dtype}]"
        k2 = f"merge_topc[sharded,{dtype},c={SHARDED_EF}]"
        records.setdefault(k1, {})["launches"] = counts["binned_scan"]
        records.setdefault(k2, {})["launches"] = counts["merge_topc"]
        width = st.scan_width(base_lo.shape[1])
        kind = torch.int8 if dtype == "int8" else torch.bfloat16
        main_path_route(records, k1, "binned_scan",
                        st.scan_cores(kind, width, f_bin), by_cores, device,
                        f"sharded fused {dtype}")
        if device.type != "cuda":
            continue
        check(counts["binned_scan"] == SHARDS
              and counts["merge_topc"] == SHARDS,
              f"the sharded {dtype} search did not launch K1 and K2 once a "
              f"shard: {counts}")
        q0 = torch.from_numpy(qlo).to(device)
        args = sh.fused_operands(q0, idx.base_lo[0], metric="l2",
                                 scan_dtype=dtype, f_pad=f_pad)
        got, rec = _scan_check(st, args, dict(bin_size=f_bin, packed=True),
                               f"sharded,{dtype}")
        if dtype == "bfloat16":
            # yardstick: the bare score product of one shard
            rec["library_ms"] = time_ms(
                lambda: torch.matmul(args[1], args[0].T), 3)
        records[k1] = {**rec, "launches": counts["binned_scan"],
                       "launches_by_cores": records[k1]["launches_by_cores"],
                       "shards_on_one_card": SHARDS}
        mrec = _merge_check(st, *got, min(SHARDED_EF, got[0].shape[0]),
                            f"sharded,{dtype},c={SHARDED_EF}")
        records[k2] = {**mrec, "launches": counts["merge_topc"],
                       "shards_on_one_card": SHARDS}
        del got, args
        torch.cuda.empty_cache()
    del idx
    t0 = time.perf_counter()
    idx = sh.build_sharded_index(base, GRAPH_K, mesh, base_lo=base_lo,
                                 with_payload=True, ncent=SHARDED_NCENT)
    say(f"sharded graph index ({note}): {time.perf_counter() - t0:.2f} s "
        f"(per-shard exact graphs, bf16 payloads, {SHARDED_NCENT} centroid "
        f"entries a shard)")
    counts, _ = run(idx, "graph_pallas", "graph_pallas",
                    {gather: ("row_gather",)})
    records.setdefault("row_gather[sharded]", {})["launches"] = \
        counts["row_gather"]
    if device.type == "cuda":
        check(counts["row_gather"] > 0, "the sharded walk launched no K3")
        # a shard's hop gathers expand (4) rows a query of its payload
        gather_check(idx.payload[0], 4 * query.shape[0], device, records,
                     name="row_gather[sharded]")


def main(device_name: str = "cuda", n: int = 1_000_000, nq: int = 16384,
         proj_file: str = "bench_proj_n1000000_d128x32_s600_sel_seed1.npz",
         targets: bool = True, timed: int = 10,
         train_steps: int = TRAIN_STEPS,
         pipeline_out: pathlib.Path = PIPELINE_OUT,
         pipeline_steps: int | None = None) -> dict:
    """Run every phase; ``targets`` holds recall and overlap to the
    reference figures, which belong to the default sizes only; ``timed``
    requests are timed per served configuration; ``train_steps`` are the
    trainer's. The pipeline phase runs its config at n / 1M of its scale,
    with ``pipeline_steps`` trainer steps (None: the config's), writing
    to ``pipeline_out``."""
    import torch

    from gbnns_tpu_torch._device import resolve_device
    from gbnns_tpu_torch.kernels import _build

    device = resolve_device(device_name)
    records: dict[str, dict] = {}
    threads_before = set(threading.enumerate())
    with Phase("build kernels"):
        if device.type == "cuda":
            t0 = time.perf_counter()
            _build.build(list(KERNEL_SOURCES))
            say(f"nvcc build: {time.perf_counter() - t0:.2f} s (" + ", ".join(
                _build.library_path(n).parent.name for n in KERNEL_SOURCES)
                + ")")
    with Phase("data"):
        base, query, base_lo, gt, trained = load_data(device, n, nq, proj_file)
    if device.type == "cuda":
        with Phase("kernels vs plain"):
            kernel_checks(base, query, base_lo, gt, trained, device,
                          records, targets)
    served = {}
    for dtype in ("bfloat16", "int8"):
        with Phase(f"serve fused {dtype}"):
            served[dtype] = serve_fused(dtype, base, query, base_lo, gt,
                                        trained, device, records, targets,
                                        timed)
    with Phase("fused shifted"):
        shifted_fused(base, query, base_lo, gt, trained, device, records,
                      served["bfloat16"]["r10"], targets, timed)
    with Phase("gated scan"):
        gated_scan(base, query, base_lo, gt, trained, device, records,
                   targets, timed)
    with Phase("ivf"):
        ivf_phase(base, query, base_lo, gt, trained, device, targets, timed)
    with Phase("train projection"):
        train_phase(base, query, gt, device, targets, train_steps)
    with Phase("graph build"):
        graph, entries, payload = graph_build(base_lo, device, records,
                                              targets)
    with Phase("exact kNN (T6)"):
        exact_knn(base_lo, device, records)
    if device.type == "cuda":
        with Phase("kernels vs plain: row_gather"):
            gather_check(payload, 4 * query.shape[0], device, records)
    with Phase("walker vs plain"):
        walker_checks(graph, entries, payload, base_lo, query, trained,
                      device)
    del payload
    with Phase("serve graph_pallas"):
        serve_graph(base, query, base_lo, gt, trained, graph, entries, device,
                    records, targets, timed)
    with Phase("pipeline sift1m_dr32"):
        pipeline_phase(graph, base_lo, device, records, targets,
                       pipeline_out, n / 1_000_000, pipeline_steps)
    del graph, entries
    with Phase("sharded"):
        sharded_phase(base, query, base_lo, gt, trained, device, records,
                      targets, timed)
    with Phase("teardown"):
        if device.type == "cuda":
            torch.cuda.synchronize()
        # every thread this run started must end (HTTP connection threads
        # end once clients close)
        started = set(threading.enumerate()) - threads_before
        for t in started:
            t.join(5)
        alive = [t.name for t in started if t.is_alive()]
        check(not alive, f"threads still running: {alive}")
    return records


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    if not (SRC / "gbnns_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/gbnns_tpu_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(1)
    t_start = time.perf_counter()
    try:
        with Phase("card"):
            say(_card_line())  # name, power limit: as nvidia-smi prints them
        recs = main()
    except Exception as e:  # noqa: BLE001 - any failure fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(1)  # exit now, even if a failed phase left a thread behind
    say(f"total: {time.perf_counter() - t_start:.2f} s")
    say(json.dumps({"kernels": list(recs.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
