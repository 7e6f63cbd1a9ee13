"""The port stands alone: no module of gbnns_tpu_torch, nor chip_smoke.py,
imports JAX, the JAX package or triton; its entry points refuse to fall back
to the CPU; chip_smoke.py refuses to run without a card or without the
repository around it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "gbnns_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    "gbnns_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")
FORBIDDEN = ("jax", "jaxlib", "gbnns_tpu", "triton", "flax", "optax")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    return env


def test_every_kernel_module_is_checked():
    for name in ("scan_topk", "distance_topk", "gather", "topk", "_build"):
        assert f"gbnns_tpu_torch.kernels.{name}" in MODULES


def test_importing_every_port_module_pulls_in_no_forbidden_package():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({FORBIDDEN!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_nothing_forbidden(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


def _small():
    rng = np.random.default_rng(0)
    return rng.normal(size=(300, 16)).astype(np.float32)


def _ctor_fused(base):
    from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex
    return FusedScanIndex(base)


def _ctor_shifted(base):
    from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex
    return FusedScanIndex(base, mode="shifted")


def _ctor_flat(base):
    from gbnns_tpu_torch.search.flat import FlatIndex
    return FlatIndex(base)


def _ctor_service(base):
    from gbnns_tpu_torch.serve import SearchService
    return SearchService(base, engine="fused")


def _ctor_knn(base):
    from gbnns_tpu_torch.kernels.topk import knn
    return knn(base[:4], base, 3)


def _ctor_projection(base):
    from gbnns_tpu_torch.dimred.train import load_projection
    return load_projection(str(ROOT / "results" /
                               "bench_proj_n3000_d128x32_s20_sel_seed1.npz"))


def _graph(base):
    return np.tile(np.arange(8, dtype=np.int32), (base.shape[0], 1))


def _ctor_graph_build(base):
    from gbnns_tpu_torch.build.knn_graph import build_knn_graph
    return build_knn_graph(base, 8, backend="fused")


def _ctor_kmeans(base):
    from gbnns_tpu_torch.build.kmeans import kmeans_fit
    return kmeans_fit(base, 8)


def _ctor_entries(base):
    from gbnns_tpu_torch.search.entries import CentroidEntries
    return CentroidEntries.build(base, ncent=8)


def _ctor_payload(base):
    from gbnns_tpu_torch.search.walker_payload import pack_hop_payload
    return pack_hop_payload(_graph(base), base)


def _ctor_graph_index(base):
    from gbnns_tpu_torch.search.graph_index import GraphIndex
    return GraphIndex.build(base, K=8, graph=_graph(base), ncent=None)


def _ctor_gated(base):
    from gbnns_tpu_torch.search.gated import GatedScanIndex
    return GatedScanIndex(base, chunk=64, sub=64, fine=4, kmeans_sample=None)


def _ctor_graph_services(base):
    from gbnns_tpu_torch.serve import SearchService
    for engine in ("graph", "graph_pallas"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SearchService(base, graph=_graph(base), engine=engine)
    raise RuntimeError("no CUDA device: both graph engines refused")


@pytest.mark.parametrize("ctor", [_ctor_fused, _ctor_shifted, _ctor_flat,
                                  _ctor_service,
                                  _ctor_knn, _ctor_projection,
                                  _ctor_graph_build, _ctor_kmeans,
                                  _ctor_entries, _ctor_payload,
                                  _ctor_graph_index, _ctor_graph_services,
                                  _ctor_gated])
def test_entry_points_raise_without_cuda(ctor):
    _no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctor(_small())


def test_cpu_runs_only_when_asked():
    from gbnns_tpu_torch._device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_knn_topk_is_exported():
    from gbnns_tpu_torch import kernels
    from gbnns_tpu_torch.kernels import distance_topk

    assert kernels.knn_topk is distance_topk.knn_topk
    assert "knn_topk" in kernels.__all__


def test_gated_index_is_exported_lazily():
    import gbnns_tpu_torch
    from gbnns_tpu_torch.search.gated import GatedScanIndex

    assert "GatedScanIndex" in dir(gbnns_tpu_torch)
    assert gbnns_tpu_torch.GatedScanIndex is GatedScanIndex


def test_cli_serve_raises_without_cuda(tmp_path):
    _no_cuda()
    from gbnns_tpu_torch import cli
    from gbnns_tpu_torch.io.vecs import write_fvecs

    write_fvecs(str(tmp_path / "base.fvecs"), _small())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--base", str(tmp_path / "base.fvecs"),
                  "--engine", "fused", "--no-warm"])


def test_cli_build_raises_without_cuda(tmp_path):
    _no_cuda()
    from gbnns_tpu_torch import cli
    from gbnns_tpu_torch.io.vecs import write_fvecs

    write_fvecs(str(tmp_path / "base.fvecs"), _small())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["build", "--base", str(tmp_path / "base.fvecs"), "--k",
                  "4", "--out", str(tmp_path / "g.npy")])
    assert not (tmp_path / "g.npy").exists()


def test_chip_smoke_refuses_without_cuda():
    _no_cuda()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert list(tmp_path.iterdir()) == [tmp_path / "chip_smoke.py"]
