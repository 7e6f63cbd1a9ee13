"""The port's headline benchmark, ``python -m gbnns_tpu_torch.bench``, run as
a user runs it (a subprocess) on the CPU at n = 3,000 with 256 queries:
its last line carries ``bench.py``'s keys plus ``device``, its fused row
clears R@10 0.5, and it writes nothing under ``results/``.

Two runs: GBNNS_BENCH_STEPS=20 finds the cached projection
``results/bench_proj_n3000_d128x32_s20_sel_seed1.npz`` (JAX's, read as it
is); 24 steps has no cached file, so the port's trainer retrains on the
subsample. Both find the cached ground truth
``results/bench_gt_n3000_q256_seed0.npz``."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_assumed",
        "baseline_source", "engine", "recall_at_1", "recall_at_10",
        "engine_bests", "n_base", "n_query", "projection", "train_s",
        "graph_build_s", "total_bench_s", "device")


def _snapshot(path: pathlib.Path) -> dict:
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in path.iterdir()}


@pytest.mark.parametrize("steps,projection", [
    ("20", "projection cache hit: bench_proj_n3000_d128x32_s20_sel_seed1.npz"),
    ("24", "projection retrained: best_step="),
], ids=["cached-projection", "retrained"])
def test_headline_run_on_the_cpu(steps, projection):
    assert (ROOT / "results" / "bench_gt_n3000_q256_seed0.npz").exists()
    cached = ROOT / "results" / f"bench_proj_n3000_d128x32_s{steps}_sel_seed1.npz"
    assert cached.exists() == (steps == "20")
    before = _snapshot(ROOT / "results")
    env = dict(os.environ, GBNNS_BENCH_CPU="1", GBNNS_BENCH_N="3000",
               GBNNS_BENCH_Q="256", GBNNS_BENCH_STEPS=steps,
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "gbnns_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert projection in proc.stderr
    assert "gt cache hit: bench_gt_n3000_q256_seed0.npz" in proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in KEYS:
        assert key in out, key
    assert out["value"] > 0 and out["device"] == "cpu"
    assert out["engine"] == "fused" and out["recall_at_10"] > 0.5
    fused = out["engine_bests"]["fused"]
    assert fused["qps_min"] <= fused["qps"] <= fused["qps_max"]
    assert {"ivf", "flat", "graph"} <= set(out["engine_bests"])
    for label in ("fused c= 12", "ivf p=  8", "flat c= 16", "graph ef= 32"):
        assert f"  {label} R@1=" in proc.stderr, label
    assert _snapshot(ROOT / "results") == before
