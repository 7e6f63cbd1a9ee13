"""QPS timing, sweeps, tracing and the sizing report: the port's
``eval/bench.py``, ``eval/trace.py`` and ``search/sizing.py`` against the JAX
package's on the same inputs (JAX on the CPU).

Tolerances: the JSON documents (``BenchResult.to_json``, ``pareto``,
``sweep``'s file, ``HbmBreakdown.as_dict``) are equal; ``cost_analysis``'s
flop count of a matrix product equals XLA's exactly (2 m k n both); the
timings are only checked for being positive and finite (a CPU run's times
say nothing of the card).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.eval import bench as jax_bench
from gbnns_tpu.eval import trace as jax_trace
from gbnns_tpu.search import sizing as jax_sizing
from gbnns_tpu_torch.eval import bench, trace
from gbnns_tpu_torch.search import sizing


def _results(mod):
    nan, inf = float("nan"), float("inf")
    rows = [("a", 16, 1000.0, 0.90, {"dist": nan}),
            ("b", 32, 800.0, 0.95, {"t": "pipelined"}),
            ("c", 48, 900.0, 0.93, {}),
            ("d", 64, 500.0, 0.99, {"bad": inf})]
    return [mod.BenchResult(label=lbl, ef=ef, qps=qps, latency_ms=1.5,
                            recall_at_1=r10 - 0.05, recall_at_10=r10,
                            n_queries=100, dist_comps_per_query=nan, hops=3,
                            extra=extra)
            for lbl, ef, qps, r10, extra in rows]


def test_bench_result_json_equals_jax():
    for mine, ref in zip(_results(bench), _results(jax_bench)):
        got = mine.to_json()
        assert got == ref.to_json()
        assert got["dist_comps_per_query"] is None
        json.dumps(got, allow_nan=False)   # strict JSON
    assert bench.TIMING_MODE == jax_bench.TIMING_MODE == "pipelined"


@pytest.mark.parametrize("attr", ["recall_at_10", "recall_at_1"])
def test_pareto_equals_jax(attr):
    got = [r.label for r in bench.pareto(_results(bench), attr)]
    want = [r.label for r in jax_bench.pareto(_results(jax_bench), attr)]
    assert got == want == ["a", "c", "b", "d"]


def test_sweep_writes_what_jax_writes(tmp_path, capsys):
    def runner(mod):
        table = {r.ef: r for r in _results(mod)}
        return lambda ef: table[ef]

    mine = tmp_path / "mine.json"
    ref = tmp_path / "ref.json"
    got = bench.sweep(runner(bench), [16, 32, 48], out_path=str(mine))
    jax_bench.sweep(runner(jax_bench), [16, 32, 48], out_path=str(ref))
    assert [r.ef for r in got] == [16, 32, 48]
    assert json.loads(mine.read_text()) == json.loads(ref.read_text())
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == out[3:]             # the same progress lines


def test_time_search_on_the_cpu():
    x = torch.randn(256, 32)
    calls = []

    def fn():
        calls.append(1)
        return torch.topk(x @ x.T, 5)

    qps, lat, out = bench.time_search(fn, 256, warmup=1, iters=4)
    assert qps > 0 and math.isfinite(qps) and lat > 0
    assert out[0].shape == (256, 5)
    assert len(calls) == 1 + 2 + 4       # warm-up, latency, pipelined
    med, res = bench.time_fn(fn, warmup=0, iters=3)
    assert med > 0 and res[1].shape == (256, 5)
    assert bench.block_until_ready({"a": [x]})["a"][0] is x


def test_cost_analysis_flops_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 48)).astype(np.float32)
    b = rng.normal(size=(48, 40)).astype(np.float32)
    ref = jax_trace.cost_analysis(lambda x, y: x @ y, jnp.asarray(a),
                                  jnp.asarray(b))
    got = trace.cost_analysis(lambda x, y: x @ y, torch.from_numpy(a),
                              torch.from_numpy(b))
    assert got["flops"] == ref["flops"] == 2 * 64 * 48 * 40
    assert set(got) == set(ref) == {"all", "summary", "flops", "bytes"}
    assert math.isnan(got["bytes"]) and got["summary"]["flops"] == got["flops"]


def test_memory_analysis_keys_equal_jax():
    a = torch.randn(16, 8)
    got = trace.memory_analysis(lambda x: x * 2, a)
    ref = jax_trace.memory_analysis(lambda x: x * 2, jnp.ones((16, 8)))
    assert set(got) == set(ref)
    assert got["argument_size_in_bytes"] == 16 * 8 * 4
    assert got["output_size_in_bytes"] == 16 * 8 * 4
    if not torch.cuda.is_available():
        assert got["temp_size_in_bytes"] is None


def test_profile_trace_records_a_running_thread(tmp_path):
    """A thread started before the trace (a service's dispatcher) has its
    named ranges in it."""
    import queue
    import threading

    todo, done = queue.Queue(), queue.Queue()

    def work():
        while (x := todo.get()) is not None:
            with torch.profiler.record_function("serve.search"):
                done.put(x @ x)

    worker = threading.Thread(target=work)
    worker.start()
    try:
        with trace.profile_trace(str(tmp_path)):
            todo.put(torch.randn(32, 32))
            done.get(timeout=30)
    finally:
        todo.put(None)
        worker.join(30)
    assert not worker.is_alive()
    events = json.loads((tmp_path / trace.TRACE_FILE).read_text())
    assert any(e.get("name") == "serve.search"
               and e.get("cat") == "user_annotation"
               for e in events["traceEvents"])


def test_profile_trace_writes_a_trace(tmp_path):
    out = tmp_path / "t"
    with trace.profile_trace(str(out)) as prof:
        with torch.profiler.record_function("stage"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    path = out / trace.TRACE_FILE
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "stage" for e in events)
    assert any(r.key == "stage" for r in prof.key_averages())
    report = tmp_path / "r.json"
    trace.dump_report(str(report), {"x": np.float32(1.5)})
    assert json.loads(report.read_text()) == {"x": "1.5"}


@pytest.mark.parametrize("n", [1_000, 1_000_000, 10_000_000])
@pytest.mark.parametrize("hbm", [16e9, 80e9])
def test_hbm_breakdown_fits_and_as_dict_equal_jax(n, hbm):
    mine = sizing.fused_index_hbm(n, 128, 32, rerank_itemsize=2)
    ref = jax_sizing.fused_index_hbm(n, 128, 32, rerank_itemsize=2)
    assert mine.as_dict() == ref.as_dict()
    assert mine.fits(hbm) == ref.fits(hbm)
    assert mine.fits(hbm, headroom=0.0) == ref.fits(hbm, headroom=0.0)


def test_graph_sizing_as_dict_keys_equal_jax():
    mine = sizing.graph_index_hbm(1_000_000, 128, 32, 32)
    ref = jax_sizing.graph_index_hbm(1_000_000, 128, 32, 32)
    assert set(mine.as_dict()) == set(ref.as_dict())
    # the port's payload rows are 128-byte lines, JAX's 4 KB tiles
    assert mine.as_dict()["payload_bytes"] < ref.as_dict()["payload_bytes"]
    assert mine.as_dict()["total_bytes"] == mine.total_bytes

