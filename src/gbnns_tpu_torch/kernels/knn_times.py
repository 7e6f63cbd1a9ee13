"""Times of the exact fused kNN (T6, ``knn_topk``) across widths and k.

    PYTHONPATH=src python3 -m gbnns_tpu_torch.kernels.knn_times \\
        [--nq 8192] [--n 1000000] [--widths 32,96,128] [--ks 33,128]

Prints one JSON line a (d, k): the mean device time of ``knn_topk`` over
``--reps`` calls after a warm-up (CUDA events), the card's name, and sums
of the result's distances and ids, which are equal across two kernels that
return the same lists. The inputs are standard normal f32, made on the
device from ``--seed``. The module calls nothing of the package but
``knn_topk(q, x, k)`` and ``resolve_device``, so a copy of it placed in
another commit's ``gbnns_tpu_torch/kernels`` times that commit's kernel on
the same inputs: run both commits in one call on one card to compare them.
``--device cpu`` runs the plain version (the tests' path; its time is the
host's).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.kernels.distance_topk import knn_topk


def _mean_ms(fn, reps: int, device: torch.device) -> float:
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def knn_times(nq: int, n: int, widths, ks, *, reps: int = 3, seed: int = 0,
              device=None) -> list[dict]:
    """One record a (d, k) of ``widths`` x ``ks``: ``knn_topk`` of ``nq``
    queries against ``n`` rows, l2, f32."""
    device = resolve_device(device)
    out = []
    for d in widths:
        gen = torch.Generator(device=device).manual_seed(seed + d)
        x = torch.randn((n, d), generator=gen, device=device)
        q = torch.randn((nq, d), generator=gen, device=device)
        for k in ks:
            dists, ids = knn_topk(q, x, k)
            ms = _mean_ms(lambda: knn_topk(q, x, k), reps, device)
            out.append({
                "nq": nq, "n": n, "d": d, "k": k, "ms": ms, "reps": reps,
                "device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                "dist_sum": float(dists.double().sum()),
                "id_sum": int(ids.long().sum())})
        del x, q
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nq", type=int, default=8192)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--widths", default="32,96,128")
    ap.add_argument("--ks", default="33,128")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    recs = knn_times(a.nq, a.n, [int(w) for w in a.widths.split(",")],
                     [int(k) for k in a.ks.split(",")], reps=a.reps,
                     seed=a.seed, device=a.device)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


if __name__ == "__main__":
    main()
