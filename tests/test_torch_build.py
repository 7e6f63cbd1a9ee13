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
    """Three of the port's libraries, six sources (libscan_topk.so is
    scan_topk.cu, scan_epilogue.cu and scan_wide.cu; libgated_topm.so is
    gated_topm.cu and gated_wide.cu): all six nvcc processes start before
    the first is waited on, each compiles one source with the Hopper flags,
    and each library of several parts is linked once its objects are
    built."""
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
    assert kinds[:6] == ["start"] * 6
    compiles = [cmd for kind, cmd in events[:6]]
    want = [_build.CSRC / f"{n}.cu" for n in (
        "scan_topk", "scan_epilogue", "scan_wide", "gated_topm", "gated_wide",
        "gather")]
    assert [cmd[-1] for cmd in compiles] == [str(w) for w in want]
    for cmd in compiles:
        assert [c for c in cmd if c.endswith(".cu")] == [cmd[-1]]
        assert "arch=compute_90a,code=sm_90a" in cmd
    assert all("-c" in cmd for cmd in compiles[:5])
    links = [cmd for kind, cmd in events[6:] if kind == "start"]
    assert len(links) == 2 and all("-shared" in cmd for cmd in links)

    def objs(cmds):
        return [cmd[cmd.index("-o") + 1] for cmd in cmds]

    # each library's link starts on its own thread, in either order
    assert sorted([c for c in link if c.endswith(".o")] for link in links) \
        == sorted([objs(compiles[:3]), objs(compiles[3:5])])
    assert kinds.count("wait") == 8
    for name in names:
        assert _build.library_path(name).exists()
        assert not list(_build.library_path(name).parent.glob("*.o"))


def test_sources_include_only_cuda_headers_and_common():
    allowed = {"<cuda_runtime.h>", "<cuda_fp16.h>", "<cooperative_groups.h>",
               "<stdint.h>", "<type_traits>", '"common.cuh"',
               '"scan_k1.cuh"'}
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


def test_sass_compare_matches_old_and_new_kernel_names():
    """The SASS comparison's names: cu++filt's forms, the parameter list
    dropped, K1's prescaled epilogue argument matched to the old name."""
    from gbnns_tpu_torch.kernels import sass_compare as sc

    new = ("void <unnamed>::binned_scan_tc_kernel<(int)32, (int)0, (bool)1, "
           "(int)0>(void const*, void const*, float const*, int, float)")
    old = ("void <unnamed>::binned_scan_tc_kernel<(int)32, (int)0, "
           "(bool)1>(void const*, void const*, float const*, int)")
    assert sc.kernel_key(new) == sc.kernel_key(old) \
        == "binned_scan_tc_kernel<(int)32, (int)0, (bool)1>"
    assert sc.kernel_key(new.replace("(int)0>", "(int)2>")).endswith(
        "(int)2>")
    assert sc.kernel_key("(anonymous namespace)::merge_topc_kernel<16, "
                         "false>(float const*, int)") == \
        "merge_topc_kernel<16, false>"
    sass = ("\tcode for sm_90a\n\t\tFunction : _Za\n\t.headerflags @\"x\"\n"
            "        /*0000*/  LDC R1, c[0x0][0x28] ;\n        ......\n\n"
            "Fatbin elf code:\n\t\tFunction : _Zb\n        /*0000*/  EXIT ;\n")
    assert sc.split_functions(sass) == {
        "_Za": "/*0000*/ LDC R1, c[0x0][0x28] ;", "_Zb": "/*0000*/ EXIT ;"}
    # cuobjdump pads its columns to a library's widest instruction: the
    # same instruction padded otherwise compares equal
    padded = sass.replace("LDC R1, c[0x0][0x28] ;",
                          "LDC R1, c[0x0][0x28] ;      /* 0x0a */")
    assert sc.split_functions(padded)["_Za"] == sc.split_functions(
        sass.replace("LDC R1, c[0x0][0x28] ;",
                     "LDC R1, c[0x0][0x28] ; /* 0x0a */"))["_Za"]
    assert sc.split_functions(" Function _Za:\nREG:40 STACK:8 LOCAL:0\n") \
        == {"_Za": "REG:40 STACK:8 LOCAL:0"}


def test_libraries_and_their_sources(tmp_path):
    """A library's parts compile beside it; a tree without them builds the
    library from its one source."""
    assert not {"scan_epilogue", "scan_wide", "gated_wide"} & set(
        _build.libraries())
    assert [p.name for p in _build.sources("scan_topk")] == [
        "scan_topk.cu", "scan_epilogue.cu", "scan_wide.cu"]
    assert [p.name for p in _build.sources("gated_topm")] == [
        "gated_topm.cu", "gated_wide.cu"]
    (tmp_path / "scan_topk.cu").write_text("// old tree\n")
    assert _build.libraries(tmp_path) == ["scan_topk"]
    assert [p.name for p in _build.sources("scan_topk", tmp_path)] == [
        "scan_topk.cu"]
