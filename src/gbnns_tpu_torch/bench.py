"""The headline benchmark on the card: ``bench.py``'s run on the port.

    PYTHONPATH=src python3 -m gbnns_tpu_torch.bench

QPS at matched recall@1/recall@10 on the SIFT-like corpus (n = 1,000,000 by
default) with the triplet-learned 128→32 linear projection and an exact
full-dimension re-rank, through the port's engines, row for row as the
repository's ``bench.py``:

  * fused  — the binned scan (kernels K1, K2) at c = 12, 16, 32, 64; with a
             bf16 re-rank; on an int8 corpus; int8 with a bf16 re-rank
  * ivf    — the cluster-pruned scan (search/ivf.py) at probes 8, 16, 32
  * flat   — the exact reduced-space scan at c = 16, 32
  * graph  — the payload walker (kernel K3) at ef 32, 48, 64, 96, when
             GBNNS_BENCH_GRAPH=1 or n <= 200,000

The projection and the ground truth come from the caches under ``results/``
that ``bench.py`` writes (read as they are). On a miss the projection is
retrained with the port's trainer on the same 262,144-row subsample and the
ground truth recomputed; either stays in memory: this module writes no file.

Each row is timed with ``eval.bench.time_search`` (pipelined, 5 batches
after warm-up) in 3 rounds: the row's QPS is their median, with the lowest
and highest beside it, since the host's clock moves a 16,384-query batch by
a millisecond or more between runs.

Prints ONE JSON line last, ``bench.py``'s keys plus ``"device"`` (the card's
name and power limit as nvidia-smi prints them; "cpu" on the CPU). Knobs
(env), as ``bench.py``: GBNNS_BENCH_N (base size), GBNNS_BENCH_Q (queries),
GBNNS_BENCH_STEPS (training steps), GBNNS_BENCH_GRAPH=1 (the graph rows at
any n), GBNNS_BENCH_NO_CACHE=1 (ignore the caches), GBNNS_BENCH_CPU=1 (run
on the CPU, without the rows ``bench.py`` skips there).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
ROUNDS = 3
BASELINE_QPS = 200_000.0


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def retrain_projection(base, d_lo: int, steps: int, device):
    """``bench.py``'s training recipe: the 262,144-row subsample of
    ``default_rng(1)``, positives its exact in-sample neighbours (k_pos
    10), ``steps`` steps of batch 1,024, validation-gated selection every
    max(50, steps // 4). Returns the trained projection and
    ``{"rows", "neighbours_s", "train_s"}``: the subsample's size and the
    seconds of its neighbours and of the training."""
    from gbnns_tpu_torch.dimred.train import TrainConfig, train_projection
    from gbnns_tpu_torch.eval.recall import exact_ground_truth

    n = base.shape[0]
    sub = np.random.default_rng(1).choice(n, size=min(262_144, n),
                                          replace=False)
    base_sub = base[sub]
    k_pos = min(10, base_sub.shape[0] - 1)
    t0 = time.perf_counter()
    train_nbrs = exact_ground_truth(base_sub, base_sub, k=k_pos + 1,
                                    q_chunk=16384, device=device)[:, 1:]
    t1 = time.perf_counter()
    trained = train_projection(base_sub, train_nbrs, TrainConfig(
        d_out=d_lo, steps=steps, batch_size=1024, k_pos=k_pos,
        eval_every=max(50, steps // 4)), device=device)
    return trained, {"rows": base_sub.shape[0], "neighbours_s": t1 - t0,
                     "train_s": time.perf_counter() - t1}


def _projection(base, d: int, d_lo: int, steps: int, use_cache: bool,
                device):
    """The cached projection of ``bench.py``, or one retrained as it
    retrains (``retrain_projection``)."""
    from gbnns_tpu_torch.dimred.train import load_projection

    n = base.shape[0]
    cache = ROOT / "results" / (
        f"bench_proj_n{n}_d{d}x{d_lo}_s{steps}_sel_seed1.npz")
    if use_cache and cache.exists():
        try:
            trained = load_projection(str(cache), device=device)
            _log(f"projection cache hit: {cache.name}")
            return trained
        except (OSError, ValueError, KeyError) as e:
            _log(f"projection cache unreadable ({e}); retraining")
    trained, _ = retrain_projection(base, d_lo, steps, device)
    _log(f"projection retrained: best_step={trained['best_step']} "
         f"val@16={trained['best_val']:.4f} "
         f"(init {trained['val_history'][0]:.4f})")
    return trained


def main() -> dict:
    t_start = time.perf_counter()
    from gbnns_tpu_torch._device import resolve_device
    from gbnns_tpu_torch.dimred.train import project
    from gbnns_tpu_torch.eval.bench import block_until_ready, time_search
    from gbnns_tpu_torch.eval.recall import exact_ground_truth, recall_at_k
    from gbnns_tpu_torch.io.synthetic import SyntheticSpec, make_synthetic
    from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex
    from gbnns_tpu_torch.search.flat import FlatIndex
    from gbnns_tpu_torch.search.ivf import IVFIndex

    cpu = bool(os.environ.get("GBNNS_BENCH_CPU"))
    device = resolve_device("cpu" if cpu else None)
    n = int(os.environ.get("GBNNS_BENCH_N", 1_000_000))
    nq = int(os.environ.get("GBNNS_BENCH_Q", 16384))
    steps = int(os.environ.get("GBNNS_BENCH_STEPS", 600))
    use_cache = not os.environ.get("GBNNS_BENCH_NO_CACHE")
    d, d_lo, K = 128, 32, 32
    r10_gate = 0.95
    card = card_line(device)
    _log(f"bench: n={n} nq={nq} d={d}->{d_lo} device={device} ({card})")

    data = make_synthetic(SyntheticSpec(
        n_base=n, n_query=nq, dim=d, n_clusters=max(64, n // 2000), seed=0))
    base, query = data["base"], data["query"]

    t0 = time.perf_counter()
    trained = _projection(base, d, d_lo, steps, use_cache, device)
    base_lo = project(trained, base)
    query_lo = project(trained, query)
    train_time = time.perf_counter() - t0
    _log(f"projection train+apply: {train_time:.1f}s")

    gt_cache = ROOT / "results" / f"bench_gt_n{n}_q{nq}_seed0.npz"
    if use_cache and gt_cache.exists():
        with np.load(gt_cache) as f:
            gt = f["gt"]
        _log(f"gt cache hit: {gt_cache.name}")
    else:
        gt = exact_ground_truth(query, base, k=10, q_chunk=16384,
                                device=device)
    q_t = torch.from_numpy(query).to(device)
    qlo_t = torch.from_numpy(query_lo).to(device)

    def timed(run):
        ids = block_until_ready(run())[0].cpu().numpy()
        r1, r10 = recall_at_k(ids, gt, 1), recall_at_k(ids, gt, 10)
        rounds = [time_search(run, nq) for _ in range(ROUNDS)]
        qps = sorted(r[0] for r in rounds)
        lat_ms = float(np.median([r[1] for r in rounds])) * 1e3
        return dict(qps=float(np.median(qps)), qps_min=qps[0],
                    qps_max=qps[-1], latency_ms=lat_ms), r1, r10

    bests: dict[str, dict | None] = {}

    def row(engine, label, knobs, run):
        t, r1, r10 = timed(run)
        _log(f"  {label} R@1={r1:.4f} R@10={r10:.4f} QPS={t['qps']:,.0f} "
             f"(rounds {t['qps_min']:,.0f}-{t['qps_max']:,.0f}; batch "
             f"{t['latency_ms']:.2f} ms)")
        b = bests.get(engine)
        if r10 >= r10_gate and (b is None or t["qps"] > b["qps"]):
            bests[engine] = dict(engine=engine, **t, r1=r1, r10=r10, **knobs)
        return r10

    # ---- fused binned scan (the flagship) --------------------------------
    fused = FusedScanIndex(base, base_lo, device=device)
    for c in (12, 16, 32, 64):
        r10 = row("fused", f"fused c={c:3d}", dict(c=c, merge="pallas|exact-cpu"),
                  lambda c=c: fused.search(q_t, qlo_t, k=10, c=c, merge=None))
        if r10 >= 0.995:
            break
    del fused

    # ---- the scan's dtype rows (skipped on the CPU, as in bench.py) ------
    if not cpu:
        variants = (
            ("fused_bf16rr", "fused/bf16rr", (12, 16, 32),
             dict(rerank_dtype=torch.bfloat16), dict(rerank="bf16")),
            ("fused_int8", "fused8", (16, 32, 64),
             dict(scan_dtype="int8"), {}),
            ("fused_int8_bf16rr", "fused8/bf16rr", (12, 16, 32),
             dict(scan_dtype="int8", rerank_dtype=torch.bfloat16),
             dict(rerank="bf16")))
        for engine, label, cs, kw, knobs in variants:
            idx = FusedScanIndex(base, base_lo, device=device, **kw)
            for c in cs:
                r10 = row(engine, f"{label} c={c:3d}",
                          dict(c=c, merge="pallas", **knobs),
                          lambda c=c: idx.search(q_t, qlo_t, k=10, c=c,
                                                 merge=None))
                if r10 >= 0.995:
                    break
            del idx

    # ---- IVF cluster-pruned scan -----------------------------------------
    t0 = time.perf_counter()
    ivf = IVFIndex.build(base, base_lo, seed=0, device=device)
    block_until_ready(ivf.blocks_lo)
    _log(f"  ivf build {time.perf_counter() - t0:.1f}s {ivf.stats}")
    for probes in (8, 16, 32):
        r10 = row("ivf", f"ivf p={probes:3d}", dict(probes=probes, c=32),
                  lambda p=probes: ivf.search(q_t, qlo_t, k=10, c=32,
                                              probes=p))
        if r10 >= 0.99:
            break
    del ivf

    # ---- flat scan -------------------------------------------------------
    flat = FlatIndex(base, base_lo, device=device)
    for c in (16, 32):
        r10 = row("flat", f"flat c={c:3d}", dict(c=c),
                  lambda c=c: flat.search(q_t, qlo_t, k=10, c=c))
        if r10 >= 0.995:
            break
    del flat

    # ---- graph engine (payload walker + centroid entries) ----------------
    build_time = 0.0
    if os.environ.get("GBNNS_BENCH_GRAPH") or n <= 200_000:
        from gbnns_tpu_torch.search.graph_index import GraphIndex

        t0 = time.perf_counter()
        gidx = GraphIndex.build(
            base, base_lo, K=K, ncent=max(64, min(4096, n // 256)),
            build_kwargs=dict(backend="fused") if n > 300_000 else None,
            device=device)
        build_time = time.perf_counter() - t0
        _log(f"  graph build (reduced space + payload + centroids): "
             f"{build_time:.1f}s")
        for ef in (32, 48, 64, 96):
            r10 = row("graph", f"graph ef={ef:3d}", dict(ef=ef),
                      lambda ef=ef: gidx.search(q_t, qlo_t, k=10, ef=ef))
            if r10 >= 0.97:
                break
        del gidx

    # the headline is the API-default engine's row (bf16 scan, f32 re-rank)
    best = bests.get("fused") or max(
        [b for b in bests.values() if b], key=lambda b: b["qps"],
        default=None)
    if best is None:
        best = dict(engine="none", qps=0.0, r1=0.0, r10=0.0)
    out = {
        "metric": f"qps@r10>={r10_gate} sift-like-{n // 1000}k "
                  f"128d->32d-learned rerank",
        "value": round(best["qps"], 1),
        "unit": "queries/s",
        "vs_baseline": round(best["qps"] / BASELINE_QPS, 4),
        "baseline_assumed": True,
        "baseline_source": "2 x 100k QPS CAGRA-class single-GPU magnitude "
                           "(PAPERS.md:7, from-memory); BASELINE.json:5 "
                           "'>=2x single-H100-class'",
        "engine": best["engine"],
        "recall_at_1": round(best.get("r1", 0.0), 4),
        "recall_at_10": round(best.get("r10", 0.0), 4),
        "engine_bests": {k: v for k, v in bests.items() if v},
        "n_base": n,
        "n_query": nq,
        "projection": "triplet-linear-128to32",
        "train_s": round(train_time, 1),
        "graph_build_s": round(build_time, 1),
        "total_bench_s": round(time.perf_counter() - t_start, 1),
        "device": card,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
