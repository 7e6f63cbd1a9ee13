"""Drive the PyTorch/CUDA port's fused-scan serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout of this repository (it imports
``src/gbnns_tpu_torch`` from beside this file and nothing of JAX). Phases,
each printing its wall time:

0. the card's name and power limit (nvidia-smi);
1. build the CUDA kernels with one nvcc call per source, into .kernel_build/;
2. the contract corpus: synthetic SIFT-like n = 1,000,000 x 128 and 16,384
   queries from seed 0, the trained 128→32 projection and the cached exact
   ground truth under results/; the port's exact kNN must reproduce that
   ground truth on the first 1,024 queries;
3. each kernel (K1 binned_scan in bf16 and int8, K2 merge_topc) against its
   plain PyTorch version on the serving shapes, with its time, the plain
   version's, one PyTorch library call's and the least time the card could
   take (bound);
4. serving: SearchService(engine="fused") in bf16 (c = 12) and int8
   (c = 16): requests through submit() and HTTP /search, /search_raw on an
   ephemeral localhost port, then the 16,384 queries, with R@1, R@10 and
   QPS (median of ten batches), the recall run with the launch counts set
   to 0 before and read after;
   R@10 must lie within 0.005 of the JAX reference's rows on these inputs;
5. teardown: services stopped, HTTP server shut down, threads joined.

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
import threading
import time

sys.dont_write_bytecode = True  # write nothing into the checkout but builds

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# The JAX reference's recall on exactly these inputs (BENCH_r05.json:
# engine_bests fused c=12 and fused_int8 c=16; the same numbers are in
# results/bench_1m_learned_r5.json).
REFERENCE = {"bfloat16": {"c": 12, "r1": 0.9999, "r10": 0.9622},
             "int8": {"c": 16, "r1": 0.9999, "r10": 0.9890}}
R10_TOL = 0.005
SCAN_RTOL = 1e-5     # fp32 sums in another order than the plain matmul
PEAK_BYTES_S = 3.35e12                      # H100 SXM HBM3
PEAK_OPS_S = {"bfloat16": 989e12, "int8": 1979e12}   # dense tensor cores
KERNEL_SOURCE = "src/gbnns_tpu_torch/kernels/csrc/scan_topk.cu"
REPLACES = {"binned_scan": "src/gbnns_tpu/kernels/scan_topk_pallas.py:44",
            "merge_topc": "src/gbnns_tpu/kernels/scan_topk_pallas.py:559"}


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


def kernel_checks(base, query, base_lo, trained, device, records):
    """Each kernel against its plain version on the serving shapes."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.kernels import scan_topk as st

    qlo = projector(trained)(torch.from_numpy(query).to(device))
    for dtype in ("bfloat16", "int8"):
        idx = st.FusedScanIndex(base, base_lo, scan_dtype=dtype, device=device)
        q_scan, alpha = idx.scan_queries(qlo)
        args = (q_scan, idx.x_lo, idx.addvec, alpha)
        kw = dict(bin_size=idx.bin_size, packed=idx.packed)
        got = st.binned_scan(*args, **kw)
        ref = st.binned_scan_plain(*args, **kw)
        torch.cuda.synchronize()
        rep = st.scan_agreement(got, ref, *args, rtol=SCAN_RTOL, **kw)
        say(f"K1 binned_scan[{dtype}] vs plain: {rep}")
        check(rep["ok"], f"K1 {dtype} disagrees with its plain version")
        B, d = q_scan.shape
        n_pad = idx.x_lo.shape[0]
        n_bins = n_pad // idx.bin_size
        ms = time_ms(lambda: st.binned_scan(*args, **kw))
        plain_ms = time_ms(lambda: st.binned_scan_plain(*args, **kw), 2)
        if dtype == "bfloat16":
            # yardstick: the bare score product, (n_pad, B) bf16 in memory
            lib_ms = time_ms(lambda: torch.matmul(idx.x_lo, q_scan.T), 3)
            torch.cuda.empty_cache()
        else:
            lib_ms = None  # an int8 product's int32 scores would take 65 GB
        el = q_scan.element_size()
        n_bytes = (B * d * el + n_pad * d * el + n_pad * 4
                   + (B * 4 if alpha is not None else 0) + n_bins * B * 8)
        b_ms, b_by = bound_ms(n_bytes, 2.0 * B * n_pad * d, dtype)
        records[f"binned_scan[{dtype}]"] = dict(
            name=f"binned_scan[{dtype}]", route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES["binned_scan"], launches=None,
            max_abs_err=rep["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        say(f"K1 [{dtype}] B={B} n_pad={n_pad} d={d}: {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, library {lib_ms} ms, bound {b_ms:.4f} ms "
            f"({b_by})")

        c = REFERENCE[dtype]["c"]
        vals, ids = got
        gm = st.merge_topc(vals, ids, c)
        rm = st.merge_topc_plain(vals, ids, c)
        torch.cuda.synchronize()
        equal = torch.equal(gm[0], rm[0]) and torch.equal(gm[1], rm[1])
        err = (gm[0] - rm[0]).abs().nan_to_num(0.0).max().item()
        say(f"K2 merge_topc[c={c}] equals plain: {equal}")
        check(equal, f"K2 (c={c}) differs from its plain version")
        ms = time_ms(lambda: st.merge_topc(vals, ids, c))
        plain_ms = time_ms(lambda: st.merge_topc_plain(vals, ids, c), 2)
        vt = vals.T.contiguous()
        lib_ms = time_ms(lambda: torch.topk(vt, c, dim=1, largest=False))
        b_ms, b_by = bound_ms(n_bins * B * 8 + B * c * 8, 0.0, "bfloat16")
        records[f"merge_topc[{dtype},c={c}]"] = dict(
            name=f"merge_topc[{dtype},c={c}]", route="cuda",
            source=KERNEL_SOURCE, replaces=REPLACES["merge_topc"],
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        say(f"K2 [c={c}] R={n_bins} B={B}: {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, topk {lib_ms:.3f} ms, bound {b_ms:.4f} ms")
        del idx, got, ref, vals, ids, vt
        torch.cuda.empty_cache()
    return records


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


def serve_run(dtype, base, query, base_lo, gt, trained, device, records,
              targets: bool):
    import numpy as np
    import torch

    from gbnns_tpu_torch.dimred.train import projector
    from gbnns_tpu_torch.eval.recall import recall_at_k
    from gbnns_tpu_torch.kernels import scan_topk as st
    from gbnns_tpu_torch.serve import (SearchService, make_server,
                                       pack_raw_request, serve,
                                       unpack_raw_response)

    ref = REFERENCE[dtype]
    c = ref["c"]
    t0 = time.perf_counter()
    svc = SearchService(base, base_lo, engine="fused", c=c,
                        projection=projector(trained), scan_dtype=dtype,
                        max_batch=4096, device=device)
    say(f"SearchService(fused, {dtype}, c={c}) up: "
        f"{time.perf_counter() - t0:.2f} s")
    httpd = make_server(svc, 0, "127.0.0.1")
    port = httpd.server_address[1]
    server = threading.Thread(target=serve, args=(svc,),
                              kwargs={"httpd": httpd}, name="smoke-http")
    server.start()
    try:
        # direct search of the same rows is the yardstick for each request
        direct = svc.fused.search(
            torch.from_numpy(query[:300]).to(device),
            projector(trained)(torch.from_numpy(query[:300]).to(device)),
            k=10, c=c)
        direct_ids = direct[0].cpu().numpy()
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

        # the main path: all queries through the service, counts from 0
        st.reset_launches()
        t0 = time.perf_counter()
        ids, _ = svc.submit(query, None, 10, timeout=600)
        first_s = time.perf_counter() - t0
        counts = dict(st.launches)
        r1 = recall_at_k(ids, gt, 1)
        r10 = recall_at_k(ids, gt, 10)
        check(ids.shape == (query.shape[0], 10) and ids.min() >= 0
              and ids.max() < base.shape[0], "result ids out of range")
        # host clock around whole requests: the host is shared, so take
        # ten and report the median and the spread
        batch_s = []
        for _ in range(10):
            t0 = time.perf_counter()
            svc.submit(query, None, 10, timeout=600)
            batch_s.append(time.perf_counter() - t0)
        q1, med, q3 = np.percentile(batch_s, [25, 50, 75])
        qps = query.shape[0] / med
        say(f"fused {dtype} c={c}: R@1={r1:.4f} R@10={r10:.4f} "
            f"QPS={qps:,.0f} (median of 10 batches; batch ms quartiles "
            f"{q1 * 1e3:.2f} / {med * 1e3:.2f} / {q3 * 1e3:.2f}, min "
            f"{min(batch_s) * 1e3:.2f}, max {max(batch_s) * 1e3:.2f}; "
            f"first batch {first_s:.3f} s) launches {counts}")
        say(json.dumps({"engine": f"fused[{dtype}]", "c": c, "r1": r1,
                        "r10": r10, "qps": qps, "batch_ms": [
                            t * 1e3 for t in batch_s],
                        "nq": query.shape[0], "reference_r10": ref["r10"]}))
        records[f"binned_scan[{dtype}]"]["launches"] = counts["binned_scan"]
        records[f"merge_topc[{dtype},c={c}]"]["launches"] = counts["merge_topc"]
        if device.type == "cuda":
            check(counts["binned_scan"] > 0 and counts["merge_topc"] > 0,
                  f"the {dtype} serving run launched no kernel: {counts}")
        if targets:
            check(abs(r10 - ref["r10"]) <= R10_TOL,
                  f"R@10 {r10:.4f} is not within {R10_TOL} of the "
                  f"reference {ref['r10']}")
    finally:
        httpd.shutdown()   # serve() returns, closes the socket, stops svc
        server.join(30)
    check(not server.is_alive(), "HTTP server thread did not stop")
    check(not svc._dispatcher.is_alive() and not svc._completer.is_alive(),
          "service threads did not stop")


def main(device_name: str = "cuda", n: int = 1_000_000, nq: int = 16384,
         proj_file: str = "bench_proj_n1000000_d128x32_s600_sel_seed1.npz",
         targets: bool = True) -> dict:
    """Run every phase; ``targets`` holds recall to the reference rows,
    which belong to the default sizes only."""
    import torch

    from gbnns_tpu_torch._device import resolve_device
    from gbnns_tpu_torch.kernels import _build

    device = resolve_device(device_name)
    records: dict[str, dict] = {}
    with Phase("build kernels"):
        if device.type == "cuda":
            t0 = time.perf_counter()
            _build.build(["scan_topk"])
            say(f"nvcc build: {time.perf_counter() - t0:.2f} s "
                f"({_build.library_path('scan_topk').parent.name})")
    with Phase("data"):
        base, query, base_lo, gt, trained = load_data(device, n, nq, proj_file)
    if device.type == "cuda":
        with Phase("kernels vs plain"):
            kernel_checks(base, query, base_lo, trained, device, records)
    for dtype in ("bfloat16", "int8"):
        records.setdefault(f"binned_scan[{dtype}]", {})
        records.setdefault(
            f"merge_topc[{dtype},c={REFERENCE[dtype]['c']}]", {})
        with Phase(f"serve fused {dtype}"):
            serve_run(dtype, base, query, base_lo, gt, trained, device,
                      records, targets)
    with Phase("teardown"):
        if device.type == "cuda":
            torch.cuda.synchronize()
        for t in threading.enumerate():
            if t is not threading.main_thread():
                t.join(5)  # HTTP connection threads end once clients close
        alive = [t.name for t in threading.enumerate()
                 if t is not threading.main_thread() and t.is_alive()]
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
