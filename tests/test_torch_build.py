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
