"""The port's ``run_pipeline`` against the JAX package's on the fixture
dataset (2,048 x 32, 128 queries), one case per index kind: the graph
walker (plain hop, payload hop with centroid entries, reduced-space graph),
the fused scan in bf16 and int8, flat, ivf, gated, and a 4-shard run. The
port runs on the CPU through the kernels' plain versions; JAX's Pallas
kernels in interpret mode, each search once (its timing loop is replaced:
QPS and seconds are not compared).

Tolerances: labels and ef equal; R@1 and R@10 within 0.005 of JAX's;
distance computations a query within 1e-3 relative (the bf16-free walks
count the same hops; a reduced-space walk may differ by a rounding tie).
A linear projection trained by the JAX run is cached in ``out_dir`` under
the key both packages compute, and the port's run loads it."""

import copy
import os

import pytest

import gbnns_tpu.eval.bench as jax_bench
from gbnns_tpu.config import ExperimentConfig as JaxConfig
from gbnns_tpu.pipeline import run_pipeline as jax_run_pipeline
from gbnns_tpu_torch.config import ExperimentConfig
from gbnns_tpu_torch.pipeline import (build_graph, fit_projection,
                                      microbatch, run_pipeline)

GRAPH = {"k": 8, "chunk": 1024, "node_chunk": 1024}
PCA = {"method": "pca", "d_out": 16}
CASES = {
    "graph": {"graph": GRAPH,
              "search": {"k": 10, "efs": [8, 16, 64], "num_entries": 16,
                         "batch_size": 48}},
    "graph_pallas_walker": {
        "graph": {**GRAPH, "space": "reduced"}, "dimred": PCA,
        "search": {"k": 10, "efs": [32], "num_entries": 8,
                   "walker": "pallas", "centroid_entries": 64,
                   "max_hops": 64}},
    "graph_reduced": {"graph": {**GRAPH, "space": "reduced"}, "dimred": PCA,
                      "search": {"k": 10, "efs": [64], "num_entries": 16}},
    "fused": {"dimred": PCA,
              "search": {"index": "fused", "k": 10, "efs": [16, 32]}},
    "fused_int8": {"dimred": PCA,
                   "search": {"index": "fused", "scan_dtype": "int8",
                              "k": 10, "efs": [16, 32]}},
    "flat": {"dimred": PCA,
             "search": {"index": "flat", "k": 10, "efs": [16, 64]}},
    "ivf": {"search": {"index": "ivf", "k": 10, "efs": [2, 8]}},
    "gated": {"search": {"index": "gated", "k": 10, "efs": [2, 8],
                         "batch_size": 64}},
    "sharded": {"n_devices": 4, "graph": GRAPH,
                "search": {"k": 10, "efs": [32], "num_entries": 16}},
}


@pytest.fixture
def jax_once(monkeypatch):
    """JAX's pipeline with one search a point (its QPS is not compared)."""
    monkeypatch.setattr(jax_bench, "time_search",
                        lambda fn, n, warmup=1, iters=3: (1.0, 1.0, fn()))


def _both(obj, tmp_path):
    obj = {"dataset": "fixture", "out_dir": str(tmp_path), **obj}
    ref = jax_run_pipeline(JaxConfig.from_json(copy.deepcopy(obj)))
    mine = run_pipeline(ExperimentConfig.from_json(copy.deepcopy(obj)),
                        device="cpu")
    return mine, ref


def _same_results(mine, ref):
    assert len(mine) == len(ref) > 0
    for a, b in zip(mine, ref):
        assert (a["label"], a["ef"], a["hops"]) == \
            (b["label"], b["ef"], b["hops"])
        assert abs(a["recall_at_1"] - b["recall_at_1"]) <= 0.005
        assert abs(a["recall_at_10"] - b["recall_at_10"]) <= 0.005
        if b["dist_comps_per_query"] is None:
            assert a["dist_comps_per_query"] is None
        else:
            assert a["dist_comps_per_query"] == pytest.approx(
                b["dist_comps_per_query"], rel=1e-3)
        assert a["qps"] > 0 and a["extra"].get("timing") == "pipelined"


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(case, tmp_path, jax_once):
    mine, ref = _both({"name": f"fx_{case}", **CASES[case]}, tmp_path)
    s, r = mine["summary"], ref["summary"]
    for key in ("name", "dataset", "n_base", "dim", "d_out", "method",
                "graph_k"):
        assert s[key] == r[key], key
    _same_results(s["results"], r["results"])
    # the frontier follows QPS, which is not compared
    assert {p["label"] for p in s["pareto"]} <= \
        {x["label"] for x in s["results"]} and s["pareto"]
    assert (s["build_time_s"] > 0) == (r["build_time_s"] > 0)
    assert (mine["graph"] is None) == (ref["graph"] is None)
    assert os.path.exists(mine["out_path"])
    assert s.get("plot", "").endswith(".png")


def test_projection_cache_written_by_jax_loads_in_the_port(tmp_path, capsys,
                                                           jax_once):
    obj = {"name": "fx_linear",
           "dimred": {"method": "linear", "d_out": 8, "steps": 40,
                      "batch_size": 128, "k_pos": 5, "eval_every": 20},
           "search": {"index": "flat", "k": 10, "efs": [32]}}
    mine, ref = _both(obj, tmp_path)
    cached = sorted(p.name for p in tmp_path.glob("proj_fx_linear_*.npz"))
    assert len(cached) == 1
    assert f"projection cache hit: {cached[0]}" in capsys.readouterr().out
    _same_results(mine["summary"]["results"], ref["summary"]["results"])
    assert mine["artifacts"]["trained"]["cfg"].eval_every == 20


def test_gated_sweep_at_the_default_batch_size(tmp_path, jax_once):
    """``search.batch_size`` 0 (the default) is the whole query set; JAX's
    gated sweep plans its kept-cell share on ``query[:0]`` and divides by
    zero, the port's on the whole set."""
    obj = {"name": "fx_gated0", "dataset": "fixture",
           "out_dir": str(tmp_path),
           "search": {"index": "gated", "k": 10, "efs": [2, 8]}}
    with pytest.raises(ZeroDivisionError):
        jax_run_pipeline(JaxConfig.from_json(copy.deepcopy(obj)))
    mine = run_pipeline(ExperimentConfig.from_json(copy.deepcopy(obj)),
                        device="cpu")["summary"]["results"]
    ref = run_pipeline(ExperimentConfig.from_json(
        {**copy.deepcopy(obj), "search": {**obj["search"],
                                          "batch_size": 128}}),
        device="cpu")["summary"]["results"]
    _same_results(mine, ref)


def test_reduced_space_needs_a_projection():
    cfg = ExperimentConfig.from_json({"name": "x", "dataset": "fixture",
                                      "graph": {"space": "reduced"}})
    with pytest.raises(ValueError, match="needs a projection"):
        build_graph(cfg, None, None, device="cpu")
    cfg.graph.space = "both"
    with pytest.raises(ValueError, match="unknown graph space"):
        build_graph(cfg, None, None, device="cpu")
    base, query, art = fit_projection(cfg, "b", "q", None, device="cpu")
    assert (base, query, art) == ("b", "q", {})


def test_microbatch_pads_the_tail_and_drops_it():
    import torch

    q = torch.arange(10, dtype=torch.float32)[:, None]
    calls = []

    def fn(a, b):
        calls.append(a.shape[0])
        return a.int(), b
    ids, dists = microbatch(fn, (q, q * 2), 4)
    assert calls == [4, 4, 4]
    assert torch.equal(ids[:, 0], torch.arange(10, dtype=torch.int32))
    assert torch.equal(dists, q * 2)
    assert microbatch(fn, (q, q), 0)[0].shape == (10, 1)
