"""chip_smoke.py's phases rehearsed on the CPU at a small size: the corpus
of n = 20,000 with its cached ground truth and projection, the fused service
in bf16 and int8 over submit() and HTTP, the shifted-key index, the gated
scan's probes sweep, the IVF index's probes sweep, the projection trainer
(40 steps), the graph build, the exact fused kNN, the walker checks, the
graph_pallas service, and a teardown that leaves no thread. (The kernel
phases, the request trace and the launch and recall checks need the
card.)"""

import importlib.util
import pathlib
import threading

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_rehearsal_on_cpu(chip_smoke, capsys, tmp_path):
    before = set(threading.enumerate())
    records = chip_smoke.main(
        "cpu", n=20000, nq=1024,
        proj_file="bench_proj_n20000_d128x32_s600_seed1.npz", targets=False,
        timed=2, train_steps=40, pipeline_out=tmp_path / "pipeline",
        pipeline_steps=40)
    out = capsys.readouterr().out
    assert "ground truth: 1024/1024 rows equal" in out
    assert out.count("1.0000 of rows equal to a direct search") == 3
    assert "reachable from the walker's entries: 20000/20000" in out
    assert out.count("identical True") == 2
    for ef in (32, 48, 64):
        assert f"graph_pallas ef={ef}: R@1=" in out
    for probes in (4, 8, 16, 32):
        assert f"gated probes={probes} c=32: R@1=" in out
    assert "GatedScanIndex: " in out and "'n_chunks': 2" in out
    assert "IVFIndex.build: " in out and "'ncent': 512" in out
    for probes in (8, 16, 32):
        assert f"ivf probes={probes} c=32: R@1=" in out
    assert "train_projection (20000 rows, 40 steps): " in out
    assert "fused bf16 c=12 over the trained projection: R@1=" in out
    assert "fused graph (20000, 32)" in out and "launches {" in out
    assert "the kernel takes d_aug = 36" in out
    assert "fused shifted c=12: R@1=" in out
    assert "knn_topk of 8192 x 20000 x 32, k=33" in out
    assert "T6 knn_topk vs knn_chunked (8192 queries):" in out
    for label in ("l2", "ip", "bf16"):
        assert f"T6 knn_topk[{label}] vs plain (1024 queries):" in out
    assert out.count("'ok': True") == 4
    assert set(records) == {"binned_scan[bfloat16]", "binned_scan[int8]",
                            "binned_scan[bfloat16,packed]",
                            "merge_topc[bfloat16,c=12]",
                            "merge_topc[int8,c=16]", "merge_topc[build,c=33]",
                            "row_gather", "gated_topm", "shifted_scan",
                            "knn_topk", "row_gather[f32]",
                            "binned_scan[sharded,bfloat16]",
                            "binned_scan[sharded,int8]",
                            "merge_topc[sharded,bfloat16,c=32]",
                            "merge_topc[sharded,int8,c=32]",
                            "row_gather[sharded]"}
    assert all(r["launches"] == 0 for r in records.values())  # CPU: plain
    # K1, T3 and T4 on the main paths: their route and their launches by
    # route (none on the CPU; the timed kernel checks, earlier_ms among
    # them, need the card)
    for name in ("binned_scan[bfloat16]", "binned_scan[int8]",
                 "binned_scan[bfloat16,packed]", "shifted_scan",
                 "gated_topm", "binned_scan[sharded,bfloat16]",
                 "binned_scan[sharded,int8]"):
        rec = records[name]
        assert rec["cores"] == "tensor", name
        assert rec["launches_by_cores"] == {"tensor": 0, "cuda": 0}, name
    for what in ("serve fused bfloat16", "serve fused int8", "graph build",
                 "fused shifted", "sharded fused bfloat16",
                 "sharded fused int8"):
        assert f"{what}: " in out and "routed to the tensor cores" in out
    for probes in (4, 8, 16, 32):
        assert (f"gated probes={probes}: gated_topm routed to the tensor "
                f"cores") in out
    # the experiment driver: the config's sweep at 20,000 rows and 800
    # queries, its stage seconds, its results under tmp_path only
    for ef in (32, 64, 128):
        assert f"pipeline sift1m_dr32 ef={ef}: R@1=" in out
    assert "[synthetic] base (20000, 128), 800 queries; stage seconds data" \
        in out
    assert (tmp_path / "pipeline" / "sift1m_dr32.json").exists()
    # the sharded engine: 8 shards of 2,500 rows on the one device
    assert "sharded scan index (8 shards on one card, 8 x 2500 rows)" in out
    for label in ("fused bfloat16", "fused int8", "graph_pallas"):
        assert f"sharded {label} ef=32 (8 shards on one card): R@1=" in out
    assert set(threading.enumerate()) <= before


def test_bound_picks_the_larger_time(chip_smoke):
    ms, by = chip_smoke.bound_ms(3.35e9, 0.0, "bfloat16")
    assert by == "bytes" and abs(ms - 1.0) < 1e-9
    ms, by = chip_smoke.bound_ms(0.0, 989e9, "bfloat16")
    assert by == "operations" and abs(ms - 1.0) < 1e-9
    assert chip_smoke.bound_ms(0.0, 1979e9, "int8")[0] == pytest.approx(1.0)


def test_check_raises(chip_smoke):
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="broken"):
        chip_smoke.check(False, "broken")


def test_hop_breakdown_runs_its_stages(chip_smoke, monkeypatch, capsys):
    """The card-only breakdown of a graph request, with the CUDA-event timer
    replaced by a call that only runs each stage."""
    import numpy as np

    from gbnns_tpu_torch.build.knn_graph import build_knn_graph
    from gbnns_tpu_torch.dimred.train import (load_projection, project,
                                              projector)
    from gbnns_tpu_torch.io.synthetic import SyntheticSpec, make_synthetic
    from gbnns_tpu_torch.serve import SearchService

    data = make_synthetic(SyntheticSpec(n_base=2048, n_query=64, dim=128,
                                        n_clusters=16, seed=3))
    trained = load_projection(
        str(ROOT / "results" / "bench_proj_n20000_d128x32_s600_seed1.npz"),
        device="cpu")
    base_lo = project(trained, data["base"])
    graph = build_knn_graph(base_lo, 12, device="cpu")
    svc = SearchService(data["base"], base_lo, graph, engine="graph_pallas",
                        projection=projector(trained), device="cpu")
    try:
        monkeypatch.setattr(chip_smoke, "time_ms",
                            lambda fn, iters=5: (fn(), 1.0)[1])
        out = chip_smoke.hop_breakdown(svc, data["query"], trained,
                                       svc.device)
    finally:
        svc.stop()
    assert out["hops"] > 0 and np.isfinite(out["walk_ms"])
    assert capsys.readouterr().out.count("hop stage") == 6


def test_build_chunk_check_runs_its_kernels(chip_smoke, monkeypatch, capsys):
    """The card-only check of K1 packed and K2 at c = K + 1 on a node chunk
    of the fused build's operands, on the CPU with the timer replaced by a
    call that only runs each kernel and no device to synchronize."""
    import numpy as np
    import torch

    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters=5: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "graph_ms",
                        lambda fn, iters=20: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    base_lo = np.random.default_rng(5).normal(size=(2048, 32)) \
        .astype(np.float32)
    records = {"merge_topc[build,c=33]": {"launches": 7}}
    chip_smoke.build_chunk_check(base_lo, torch.device("cpu"), records)
    out = capsys.readouterr().out
    assert "K1 binned_scan[bfloat16,packed] vs plain" in out
    assert "K2 merge_topc[build,c=33] equals plain: True" in out
    scan = records["binned_scan[bfloat16,packed]"]
    merge = records["merge_topc[build,c=33]"]
    assert scan["max_abs_err"] == 0.0 and scan["bound_ms"] > 0
    assert scan["library_ms"] == 1.0 and merge["library_ms"] == 1.0
    assert merge["launches"] == 7   # the build run's count is kept
    assert set(merge) == set(scan) | {"graph_ms"}   # K2's graph replays
    # K2's bound: the values once, a 32-byte sector a winner's id, the
    # output; its eager time and its time in CUDA-graph replays
    import re

    R, B = map(int, re.search(r"K2 \[build,c=33\] R=(\d+) B=(\d+)",
                              out).groups())
    c = 33
    assert merge["earlier_ms"] is None and merge["graph_ms"] == 1.0
    assert merge["bound_by"] == "bytes"
    assert abs(merge["bound_ms"] - (R * B * 4 + B * c * 40)
               / chip_smoke.PEAK_BYTES_S * 1e3) < 1e-12


@pytest.mark.parametrize("name", ["row_gather", "row_gather[f32]",
                                  "row_gather[sharded]"])
def test_gather_check_records_under_its_name(chip_smoke, monkeypatch, capsys,
                                              name):
    """The card-only check of K3 on a payload, on the CPU with the timer
    replaced: its record goes under the name asked for, with every key of
    the kernels' line, and keeps the launches a main path counted."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.search.walker_payload import pack_hop_payload

    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters=5: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rng = np.random.default_rng(6)
    base = rng.normal(size=(256, 8)).astype(np.float32)
    graph = rng.integers(0, 256, size=(256, 4)).astype(np.int32)
    payload = pack_hop_payload(graph, base, device="cpu")
    records = {name: {"launches": 9}}
    chip_smoke.gather_check(payload, 512, torch.device("cpu"), records,
                            name=name)
    assert set(records) == {name}
    rec = records[name]
    assert rec["name"] == name and rec["launches"] == 9
    assert {"route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"} <= set(rec)
    assert rec["bound_ms"] == pytest.approx(
        (2 * 512 * payload.words * 4 + 512 * 4) / chip_smoke.PEAK_BYTES_S
        * 1e3)
    assert f"K3 {name} vs plain (512 rows" in capsys.readouterr().out


def test_gated_check_runs_its_kernel(chip_smoke, monkeypatch, capsys):
    """The card-only check of T4 against its plain version on a planned
    batch, on the CPU with the timer replaced by a call that only runs each
    function and no device to synchronize."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.search.gated import GatedScanIndex

    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters=5: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rng = np.random.default_rng(6)
    base = rng.normal(size=(4096, 32)).astype(np.float32)
    idx = GatedScanIndex(base, fine=4, m=16, sub=64, chunk=512, tq=64,
                         kmeans_sample=None, device="cpu")
    records = {"gated_topm": {"launches": 1}}
    ql = torch.from_numpy(rng.normal(size=(200, 32)).astype(np.float32))
    chip_smoke.gated_check(idx, ql, records)
    out = capsys.readouterr().out
    assert "T4 gated_topm vs plain (probes 16)" in out and "'ok': True" in out
    rec = records["gated_topm"]
    assert rec["max_abs_err"] == 0.0 and rec["bound_ms"] > 0
    assert rec["library_ms"] is None and rec["yardstick_ms"] == 1.0
    assert rec["launches"] == 1        # the main path's count is kept
    assert rec["cores"] == "cuda"      # fine 4: the CUDA-core route
    assert set(rec) >= {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"}


def test_gated_check_holds_both_routes(chip_smoke, monkeypatch, capsys):
    """At a geometry ``gated_cores`` sends to the tensor cores, the check
    also holds the CUDA-core kernel (timed as ``earlier_ms``) against the
    plain version, and records its error."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.search.gated import GatedScanIndex

    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters=5: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rng = np.random.default_rng(7)
    base = rng.normal(size=(4096, 32)).astype(np.float32)
    idx = GatedScanIndex(base, fine=32, m=16, sub=256, chunk=1024, tq=64,
                         kmeans_sample=None, device="cpu")
    records = {}
    ql = torch.from_numpy(rng.normal(size=(200, 32)).astype(np.float32))
    chip_smoke.gated_check(idx, ql, records)
    out = capsys.readouterr().out
    for cores in ("tensor", "cuda"):
        assert (f"T4 gated_topm vs plain (probes 16) on the {cores} cores: "
                in out)
    assert out.count("'ok': True") == 2
    rec = records["gated_topm"]
    assert rec["cores"] == "tensor"
    assert rec["max_abs_err"] == rec["earlier_max_abs_err"] == 0.0
    assert rec["earlier_ms"] == 1.0


def test_shifted_kernel_check_runs_its_kernel(chip_smoke, monkeypatch,
                                             capsys):
    """The card-only check of T3 against its plain version (bf16 at the
    index's shape, fp16 and f32 on a slice) and its record, on the CPU with
    the timers replaced by a call that only runs each function and no
    device to synchronize."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.kernels import scan_topk as st

    for timer in ("time_ms", "median_ms"):
        monkeypatch.setattr(chip_smoke, timer,
                            lambda fn, iters=5: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rng = np.random.default_rng(7)
    base = rng.normal(size=(3000, 48)).astype(np.float32)
    lo = base[:, :32].copy()
    idx = st.FusedScanIndex(base, lo, mode="shifted", chunk=1024,
                            device="cpu")
    ql = torch.from_numpy(rng.normal(size=(100, 32)).astype(np.float32))
    records = {"shifted_scan": {"launches": 1}}
    chip_smoke.shifted_kernel_check(st, idx, ql, base, lo,
                                    torch.device("cpu"), records)
    out = capsys.readouterr().out
    for label in ("bfloat16", "float16", "float32"):
        assert f"T3 shifted_scan[{label}] vs plain" in out
    assert out.count("'ok': True") == 3
    rec = records["shifted_scan"]
    assert rec["max_abs_err"] == 0.0 and rec["bound_ms"] > 0
    assert rec["library_ms"] == 1.0 and rec["launches"] == 1


def test_knn_record_runs_its_kernel(chip_smoke, monkeypatch, capsys):
    """The card-only record of T6, on the CPU with the timer replaced by a
    call that only runs each function."""
    import numpy as np
    import torch

    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters=5: (fn(), 1.0)[1])
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(3000, 32)).astype(np.float32))
    records = {"knn_topk": {"launches": 1}}
    chip_smoke.knn_record(x[:200], x, 2e-6, records)
    out = capsys.readouterr().out
    assert "yardstick knn_chunked 1.000 ms" in out
    rec = records["knn_topk"]
    assert rec["launches"] == 1 and rec["max_abs_err"] == 2e-6
    assert rec["library_ms"] is None and rec["yardstick_ms"] == 1.0
    assert rec["bound_ms"] > 0 and rec["matmul_ms"] == 1.0
    assert set(rec) >= {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"}


def test_gated_check_holds_both_routes(chip_smoke, monkeypatch, capsys):
    """At a geometry ``gated_cores`` sends to the tensor cores, the check
    also holds the CUDA-core kernel (timed as ``earlier_ms``) against the
    plain version, and records its error."""
    import numpy as np
    import torch

    from gbnns_tpu_torch.search.gated import GatedScanIndex

    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters=5: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rng = np.random.default_rng(7)
    base = rng.normal(size=(4096, 32)).astype(np.float32)
    idx = GatedScanIndex(base, fine=32, m=16, sub=256, chunk=1024, tq=64,
                         kmeans_sample=None, device="cpu")
    records = {}
    ql = torch.from_numpy(rng.normal(size=(200, 32)).astype(np.float32))
    chip_smoke.gated_check(idx, ql, records)
    out = capsys.readouterr().out
    for cores in ("tensor", "cuda"):
        assert (f"T4 gated_topm vs plain (probes 16) on the {cores} cores: "
                in out)
    assert out.count("'ok': True") == 2
    rec = records["gated_topm"]
    assert rec["cores"] == "tensor"
    assert rec["max_abs_err"] == rec["earlier_max_abs_err"] == 0.0
    assert rec["earlier_ms"] == 1.0


def test_teardown_checks_only_the_runs_own_threads(chip_smoke, monkeypatch):
    """A thread alive before the run (another test's daemon, say) is not the
    run's to stop; a thread the run leaves behind fails it."""
    stop = threading.Event()
    foreign = threading.Thread(target=stop.wait, daemon=True)
    foreign.start()
    monkeypatch.setattr(chip_smoke, "load_data", lambda *a: (None,) * 5)
    monkeypatch.setattr(chip_smoke, "serve_fused",
                        lambda *a, **k: {"r10": 1.0})
    monkeypatch.setattr(chip_smoke, "shifted_fused", lambda *a, **k: {})
    monkeypatch.setattr(chip_smoke, "gated_scan", lambda *a, **k: [])
    monkeypatch.setattr(chip_smoke, "ivf_phase", lambda *a, **k: [])
    monkeypatch.setattr(chip_smoke, "train_phase", lambda *a, **k: {})
    monkeypatch.setattr(chip_smoke, "exact_knn", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "graph_build",
                        lambda *a, **k: (None, None, None))
    monkeypatch.setattr(chip_smoke, "walker_checks", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "serve_graph", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "pipeline_phase", lambda *a, **k: {})
    monkeypatch.setattr(chip_smoke, "sharded_phase", lambda *a, **k: None)
    try:
        chip_smoke.main("cpu", targets=False)
        left = threading.Thread(target=stop.wait, daemon=True)
        monkeypatch.setattr(chip_smoke, "serve_graph",
                            lambda *a, **k: left.start())
        with pytest.raises(chip_smoke.SmokeFailure,
                           match="threads still running"):
            chip_smoke.main("cpu", targets=False)
    finally:
        stop.set()
        foreign.join(5)
    assert not foreign.is_alive()


def test_trace_breakdown_attributes_device_work(chip_smoke):
    """A request trace's events, as the profiler writes them on the card:
    each kernel or copy goes to the innermost named range of the thread
    that launched it (through the correlation id), K1 and K2 by name; the
    device's busy time is the union of its intervals."""
    def rng(name, ts, dur, tid=7):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                "dur": dur, "tid": tid}

    def launch(corr, ts, tid=7):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}

    def work(name, corr, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": 99, "args": {"correlation": corr}}

    events = [
        rng("serve.upload", 0, 1000), launch(1, 10),
        work("Memcpy HtoD (Pageable -> Device)", 1, 20, 500, "gpu_memcpy"),
        rng("serve.project", 1000, 200), launch(2, 1010),
        work("sm90_xmma_gemm", 2, 1100, 100),
        rng("serve.search", 1200, 3000), launch(3, 1210),
        work("void binned_scan_tc_kernel<1>", 3, 1300, 2000),
        launch(4, 1220), work("merge_topc_kernel<16, false>", 4, 3300, 100),
        rng("fused.rerank", 3500, 500), launch(5, 3600),
        work("gather_kernel", 5, 3700, 300),
        launch(6, 3700, tid=8), work("elementwise", 6, 4000, 50),
        work("orphan", 77, 4100, 10),
    ]
    out = chip_smoke.trace_breakdown(events, [0.005, 0.005])
    ms = out["device_ms"]
    assert out["requests"] == 2 and out["wall_ms"] == pytest.approx(5.0)
    assert ms["serve.upload (copy)"] == pytest.approx(0.25)
    assert ms["serve.project"] == pytest.approx(0.05)
    assert ms["K1 binned_scan"] == pytest.approx(1.0)
    assert ms["K2 merge_topc"] == pytest.approx(0.05)
    assert ms["fused.rerank"] == pytest.approx(0.15)
    assert ms["outside the named stages"] == pytest.approx(0.025)
    assert ms["unattributed"] == pytest.approx(0.005)
    # busy: [20, 520] + [1100, 1200] + [1300, 3300] + [3300, 3400] +
    # [3700, 4000] + [4000, 4050] + [4100, 4110] = 3060 us over 2 requests
    assert out["device_busy_ms"] == pytest.approx(1.53)
    assert out["device_idle_share"] == pytest.approx(1 - 1.53 / 5.0)
    assert out["host_span_ms"]["serve.search"] == pytest.approx(1.5)
