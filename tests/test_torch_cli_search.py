"""The port's ``search``, ``sweep``, ``plot``, ``size`` and ``pipeline``
subcommands against the JAX package's CLI on the same staged files (the
fixture corpus as fvecs, its ground truth as ivecs, one graph npy built by
the JAX CLI). The port runs with ``--device cpu``.

Tolerances: the JSON each prints (``search``, ``pipeline``) or writes
(``sweep``) is equal key by key except the timing (``qps``,
``latency_ms``), with distance computations a query within 1e-3 relative;
``size`` prints equal JSON for the scan engines, one device or sharded."""

import json

import pytest

from gbnns_tpu import cli as jax_cli
from gbnns_tpu_torch import cli
from gbnns_tpu_torch.io.vecs import write_fvecs, write_ivecs
from gbnns_tpu_torch.search import sizing

TIMING = ("qps", "latency_ms")


@pytest.fixture(scope="module")
def staged(tmp_path_factory, fixture_data, fixture_gt):
    d = tmp_path_factory.mktemp("cli_search")
    base, query = fixture_data
    write_fvecs(str(d / "base.fvecs"), base)
    write_fvecs(str(d / "query.fvecs"), query)
    write_ivecs(str(d / "gt.ivecs"), fixture_gt[:, :10])
    jax_cli.main(["build", "--base", str(d / "base.fvecs"), "--k", "8",
                  "--chunk", "1024", "--node-chunk", "1024", "--out",
                  str(d / "graph.npy")])
    return d


def _printed_json(out: str):
    """The JSON object a subcommand printed with indent=2 (lines from a
    bare "{" to the bare "}" after it)."""
    lines = out.splitlines()
    start = lines.index("{")
    return json.loads("\n".join(lines[start:lines.index("}", start) + 1]))


def _same_result(a: dict, b: dict):
    a, b = dict(a), dict(b)
    assert a.pop("qps") > 0 and "latency_ms" in a
    for key in TIMING:
        a.pop(key, None)
        b.pop(key, None)
    dq_a, dq_b = a.pop("dist_comps_per_query"), b.pop("dist_comps_per_query")
    assert (dq_a is None) == (dq_b is None)
    if dq_b is not None:
        assert dq_a == pytest.approx(dq_b, rel=1e-3)
    assert a == b


def _search_args(staged, *extra):
    return ["--base", str(staged / "base.fvecs"), "--query",
            str(staged / "query.fvecs"), "--gt", str(staged / "gt.ivecs"),
            *extra]


@pytest.mark.parametrize("extra", [
    ["--graph", "GRAPH", "--ef", "32"],
    ["--graph", "GRAPH", "--ef", "32", "--engine", "graph_pallas",
     "--centroid-entries", "32", "--num-entries", "8"],
    ["--engine", "fused", "--ef", "16", "--scan-dtype", "int8"],
    ["--n-devices", "4", "--sharded-engine", "flat", "--ef", "32"],
], ids=["graph", "graph_pallas", "fused-int8", "sharded-flat"])
def test_search_prints_what_jax_prints(staged, capsys, extra, tmp_path):
    extra = [str(staged / "graph.npy") if e == "GRAPH" else e for e in extra]
    jax_cli.main(["search", *_search_args(staged, *extra), "--out",
                  str(tmp_path / "ids_jax.ivecs")])
    ref = _printed_json(capsys.readouterr().out)
    cli.main(["search", *_search_args(staged, *extra), "--out",
              str(tmp_path / "ids.ivecs"), "--device", "cpu"])
    mine = _printed_json(capsys.readouterr().out)
    _same_result(mine, ref)
    assert (tmp_path / "ids.ivecs").read_bytes() == \
        (tmp_path / "ids_jax.ivecs").read_bytes()


@pytest.mark.parametrize("extra", [
    ["--engine", "flat", "--efs", "16,32"],
    ["--n-devices", "4", "--sharded-engine", "fused", "--efs", "16,32"],
], ids=["flat", "sharded-fused"])
def test_sweep_writes_what_jax_writes(staged, extra, tmp_path):
    jax_cli.main(["sweep", *_search_args(staged, *extra), "--out",
                  str(tmp_path / "jax.json")])
    cli.main(["sweep", *_search_args(staged, *extra), "--out",
              str(tmp_path / "port.json"), "--device", "cpu"])
    mine = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert len(mine) == len(ref) == 2
    for a, b in zip(mine, ref):
        _same_result(a, b)


@pytest.mark.parametrize("argv", [
    ["--engine", "fused", "--n", "1000000", "--d", "128", "--d-lo", "32"],
    ["--engine", "fused", "--scan-dtype", "int8", "--n", "1000000", "--d",
     "960", "--d-lo", "128"],
    ["--engine", "flat", "--n", "20000000", "--d", "960", "--d-lo", "128",
     "--rerank-dtype", "bfloat16"],
    ["--engine", "fused", "--chips", "8", "--n", "10000000", "--d", "96",
     "--d-lo", "32"],
], ids=["fused", "fused-int8", "flat-too-big", "sharded-fused"])
def test_size_prints_what_jax_prints(argv, capsys):
    jax_cli.main(["size", *argv])
    ref = _printed_json(capsys.readouterr().out)
    cli.main(["size", *argv])
    out = capsys.readouterr().out
    assert _printed_json(out) == ref
    fits = sizing.HbmBreakdown(**{k: ref[k] for k in (
        "engine", "n", "payload_bytes", "reduced_bytes", "rerank_bytes",
        "graph_bytes", "norms_bytes")}).fits(80e9)
    assert ("does NOT fit an 80 GB H100" in out) == (not fits)


def test_size_of_the_graph_engines_uses_the_ports_rows(capsys):
    cli.main(["size", "--engine", "graph_pallas", "--n", "1000000", "--d",
              "128", "--d-lo", "32", "--chips", "4"])
    got = _printed_json(capsys.readouterr().out)
    want = sizing.sharded_per_chip_hbm(1_000_000, 4, 128, 32, 32).as_dict()
    assert got == {**want, "chips": 4}
    cli.main(["size", "--engine", "graph", "--n", "1000", "--d", "128",
              "--d-lo", "32", "--K", "16"])
    got = _printed_json(capsys.readouterr().out)
    assert got["payload_bytes"] == 1000 * sizing.payload_row_bytes(16, 32)


def test_plot_writes_a_png(staged, tmp_path):
    pytest.importorskip("matplotlib")
    cli.main(["sweep", *_search_args(staged, "--engine", "flat", "--efs",
                                     "16,32"), "--out",
              str(tmp_path / "flat.json"), "--device", "cpu"])
    out = tmp_path / "curves.png"
    cli.main(["plot", f"flat={tmp_path / 'flat.json'}",
              str(tmp_path / "flat.json"), "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_pipeline_config_prints_what_jax_prints(tmp_path, capsys):
    cfg = {"name": "fx_cli", "dataset": "fixture",
           "graph": {"k": 8, "chunk": 1024, "node_chunk": 1024},
           "dimred": {"method": "pca", "d_out": 16},
           "search": {"index": "flat", "k": 10, "efs": [16, 32]}}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({**cfg, "out_dir": str(tmp_path / name)}))
        main(["pipeline", "--config", str(path), *extra])
        out = _printed_json(capsys.readouterr().out)
        if name == "jax":
            ref = out
    assert set(out) == set(ref)
    for a, b in zip(out.pop("results"), ref.pop("results")):
        _same_result(a, b)
    for key in ("pareto", "plot"):
        out.pop(key, None), ref.pop(key, None)
    assert out == ref
    assert (tmp_path / "port" / "fx_cli.json").exists()
