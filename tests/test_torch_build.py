"""The kernel build: one nvcc call per source into a directory keyed by the
source and flags, reused when it is there; nothing built at import time."""

import subprocess

import pytest

from gbnns_tpu_torch.kernels import _build


@pytest.fixture
def fake_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('extern "C" int f() { return 0; }\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / ".kernel_build")
    return csrc


def test_build_path_is_keyed_by_source(fake_csrc):
    first = _build.library_path("k")
    assert first.parent.parent == _build.BUILD_ROOT
    assert first.name == "libk.so"
    (fake_csrc / "k.cu").write_text('extern "C" int f() { return 1; }\n')
    assert _build.library_path("k") != first


def test_existing_build_is_reused(fake_csrc, monkeypatch):
    out = _build.library_path("k")
    out.parent.mkdir(parents=True)
    out.write_bytes(b"built before")

    def no_nvcc():
        raise AssertionError("nvcc must not run for a built source")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    _build.build(["k"])
    assert out.read_bytes() == b"built before"


def test_one_nvcc_call_per_source_with_the_hopper_flags(fake_csrc,
                                                        monkeypatch):
    calls = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            with open(self.out, "wb") as f:
                f.write(b"so")
            return "", None

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    (fake_csrc / "m.cu").write_text("// second source\n")
    _build.build(["k", "m"])
    assert len(calls) == 2
    for cmd in calls:
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
        assert not any("torch" in c or "cutlass" in c for c in cmd)
    assert _build.library_path("k").read_bytes() == b"so"
    assert not list(_build.library_path("k").parent.glob("*.tmp"))


def test_failed_build_raises_with_the_compiler_output(fake_csrc, monkeypatch):
    class FailingProc:
        returncode = 1

        def __init__(self, cmd, **kw):
            pass

        def communicate(self):
            return "error: expected a ';'", None

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FailingProc)
    with pytest.raises(RuntimeError, match="expected a ';'"):
        _build.build(["k"])
    assert not _build.library_path("k").exists()


def test_no_kernel_source_includes_torch_headers():
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        assert "torch/extension.h" not in text and "cutlass" not in text


def test_each_real_source_gets_its_own_nvcc_process(tmp_path, monkeypatch):
    """The port's three sources: all three nvcc processes start before the
    first is waited on, each compiles one source with the Hopper flags."""
    events = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            events.append(("start", cmd))
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            events.append(("wait", None))
            with open(self.out, "wb") as f:
                f.write(b"so")
            return "", None

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / ".kernel_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    names = ["scan_topk", "gated_topm", "gather"]
    _build.build(names)
    kinds = [e[0] for e in events]
    assert kinds == ["start"] * 3 + ["wait"] * 3
    for name, (_, cmd) in zip(names, events):
        assert cmd[-1] == str(_build.CSRC / f"{name}.cu")
        assert [c for c in cmd if c.endswith(".cu")] == [cmd[-1]]
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert _build.library_path(name).exists()


def test_sources_include_only_cuda_headers_and_common():
    allowed = {"<cuda_runtime.h>", "<cuda_fp16.h>", "<cooperative_groups.h>",
               "<stdint.h>", "<type_traits>", '"common.cuh"'}
    sources = sorted(_build.CSRC.glob("*.cu")) + sorted(
        _build.CSRC.glob("*.cuh"))
    assert {p.name for p in sources} >= {"scan_topk.cu", "gated_topm.cu",
                                         "gather.cu", "shifted_scan.cu",
                                         "distance_topk.cu", "common.cuh"}
    for src in sources:
        for line in src.read_text().splitlines():
            if line.startswith("#include"):
                assert line.split()[1] in allowed, (src.name, line)


def test_build_path_follows_the_shared_header(fake_csrc):
    (fake_csrc / "common.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    (fake_csrc / "common.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first
