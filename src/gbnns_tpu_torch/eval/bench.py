"""QPS timing and recall-vs-QPS sweeps.

Port of ``gbnns_tpu/eval/bench.py``. The query batch is resident on the
device and timed end to end after warm-up. Where JAX waits with
``block_until_ready``, this module waits with ``torch.cuda.synchronize``
for each card a result lies on, and not at all for results on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable

import numpy as np
import torch

# QPS definition of time_search: every iteration dispatched, one wait at
# the end. Sweeps stamp it into BenchResult.extra["timing"].
TIMING_MODE = "pipelined"


@dataclasses.dataclass
class BenchResult:
    label: str
    ef: int
    qps: float
    latency_ms: float          # per-batch wall time
    recall_at_1: float
    recall_at_10: float
    n_queries: int
    dist_comps_per_query: float
    hops: int
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        """Strict JSON: non-finite floats become null."""
        def clean(v):
            if isinstance(v, float) and not np.isfinite(v):
                return None
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items()}
            return v
        return {k: clean(v) for k, v in dataclasses.asdict(self).items()}


def _devices(out, found: set) -> set:
    """The CUDA devices the tensors in ``out`` (nested tuples, lists and
    dicts) lie on."""
    if torch.is_tensor(out):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _devices(x, found)
    return found


def block_until_ready(out):
    """Wait until the work behind ``out`` is done on every card it lies on;
    results on the CPU are ready already. Returns ``out``."""
    for dev in _devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def time_fn(fn: Callable[[], Any], *, warmup: int = 2,
            iters: int = 5) -> tuple[float, Any]:
    """Median wall-clock seconds of ``fn``, each call waited for."""
    out = None
    for _ in range(warmup):
        out = block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def time_search(search_fn: Callable[[], Any], n_queries: int, *,
                warmup: int = 2, iters: int = 5) -> tuple[float, float, Any]:
    """Returns (qps, seconds_per_batch_latency, last_result).

    QPS is measured pipelined: all ``iters`` batches dispatched, one wait
    at the end, as a server enqueues the next batch while one runs. The
    latency is the median of batches waited for one at a time."""
    sec_lat, _ = time_fn(search_fn, warmup=warmup, iters=max(2, iters // 2))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = search_fn()
    block_until_ready(out)
    sec_thr = (time.perf_counter() - t0) / iters
    return n_queries / sec_thr, sec_lat, out


def sweep(run_one: Callable[[int], BenchResult], efs: list[int],
          *, out_path: str | None = None,
          verbose: bool = True) -> list[BenchResult]:
    """Run ``run_one(ef)`` for each ef; collect the recall-vs-QPS curve and
    optionally write it as strict JSON."""
    results = []
    for ef in efs:
        r = run_one(ef)
        results.append(r)
        if verbose:
            dq = r.dist_comps_per_query
            dq_s = f"{dq:,.0f}" if dq is not None and np.isfinite(dq) else "-"
            print(f"  ef={ef:4d}  R@1={r.recall_at_1:.4f}  "
                  f"R@10={r.recall_at_10:.4f}  QPS={r.qps:,.0f}  "
                  f"dist/q={dq_s}  hops={r.hops}", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump([r.to_json() for r in results], f, indent=2,
                      allow_nan=False)
    return results


def pareto(results: list[BenchResult],
           recall_attr: str = "recall_at_10") -> list[BenchResult]:
    """Points on the recall-vs-QPS Pareto frontier (higher is better on
    both)."""
    pts = sorted(results, key=lambda r: -r.qps)
    frontier, best_recall = [], -1.0
    for r in pts:
        rec = getattr(r, recall_attr)
        if rec > best_recall:
            frontier.append(r)
            best_recall = rec
    return frontier
