"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Each library ``lib<name>.so`` comes from ``csrc/<name>.cu`` and the sources
``PARTS`` names beside it; they have a plain C interface and include no
PyTorch or CUTLASS header (only the shared ``csrc/*.cuh``), so nvcc builds
them in seconds (a source that includes PyTorch's headers takes minutes).
A library of one source is one ``nvcc -shared`` call; one of several
sources compiles each to an object, all at once, then links them, so that
its halves build in parallel. The shared library goes to
``<repo>/.kernel_build/<name>-<hash>/``, keyed by a hash of its sources,
the headers and the flags, so a second run reuses it. Nothing is built at
import time: the first wrapper call on a CUDA tensor builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / ".kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# A library's sources beside <name>.cu, compiled apart from it, in
# parallel: K1's unprescaled and shifted epilogues and its tensor-core
# kernels at d > 128 (libscan_topk.so), T4 at d > 128 (libgated_topm.so)
PARTS = {"scan_topk": ("scan_epilogue", "scan_wide"),
         "gated_topm": ("gated_wide",)}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's kernels are built with the CUDA toolkit")
    return str(path)


def sources(name: str, csrc: pathlib.Path | None = None) -> list[pathlib.Path]:
    """The sources of ``lib<name>.so`` in ``csrc`` (``CSRC``): ``<name>.cu``
    and those of its ``PARTS`` that ``csrc`` holds."""
    csrc = csrc or CSRC
    parts = [csrc / f"{p}.cu" for p in PARTS.get(name, ())]
    return [csrc / f"{name}.cu"] + [p for p in parts if p.exists()]


def libraries(csrc: pathlib.Path | None = None) -> list[str]:
    """Every library ``csrc`` (``CSRC``) builds: its ``.cu`` files but the
    parts."""
    parts = {p for ps in PARTS.values() for p in ps}
    return sorted(f.stem for f in (csrc or CSRC).glob("*.cu")
                  if f.stem not in parts)


def library_path(name: str, csrc: pathlib.Path | None = None,
                 root: pathlib.Path | None = None) -> pathlib.Path:
    """Where ``lib<name>.so`` is built (under ``root``, ``BUILD_ROOT``):
    keyed by its sources, the shared headers (``csrc/*.cuh``) and the
    flags."""
    csrc = csrc or CSRC
    text = b"".join(src.read_bytes() for src in sources(name, csrc))
    text += b"".join(h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return (root or BUILD_ROOT) / f"{name}-{digest}" / f"lib{name}.so"


def _popen(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start_build(name: str, csrc, root):
    """Start the nvcc processes of ``lib<name>.so``; None if it is built.
    Returns (processes, objects to link or None, temporary output)."""
    out = library_path(name, csrc, root)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    srcs = sources(name, csrc)
    if len(srcs) == 1:
        return [_popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                        str(srcs[0])])], None, tmp
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [out.with_name(f"{src.stem}.{os.getpid()}.o") for src in srcs]
    return [_popen([_nvcc(), *flags, "-c", "-o", str(obj), str(src)])
            for src, obj in zip(srcs, objs)], objs, tmp


def _finish(job) -> str | None:
    """Wait for a library's processes, link its objects when it has several
    sources; returns the compiler's output on failure."""
    procs, objs, tmp = job
    logs = [proc.communicate()[0] for proc in procs]
    failed = [log for proc, log in zip(procs, logs) if proc.returncode != 0]
    if not failed and objs is not None:
        link = _popen([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)])
        log = link.communicate()[0]
        if link.returncode != 0:
            failed.append(log)
    for obj in objs or ():
        obj.unlink(missing_ok=True)
    return "\n".join(failed) if failed else None


def build(names: list[str], csrc: pathlib.Path | None = None,
          root: pathlib.Path | None = None) -> dict[str, float]:
    """Build every named library that is not built yet, every nvcc process
    started together; returns each built library's seconds from the start
    until it was in place. Raises with the compiler's output."""
    t0 = time.perf_counter()
    jobs = {name: _start_build(name, csrc, root) for name in names}
    secs, errors = {}, []

    def finish(name, job):
        err = _finish(job)
        if err is None:    # atomic: no half-written .so
            os.replace(job[2], library_path(name, csrc, root))
        else:
            job[2].unlink(missing_ok=True)
            errors.append(f"nvcc failed for lib{name}.so:\n{err}")
        secs[name] = round(time.perf_counter() - t0, 2)

    waits = [threading.Thread(target=finish, args=(name, job))
             for name, job in jobs.items() if job is not None]
    for t in waits:
        t.start()
    for t in waits:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The built ``lib<name>.so``, building it on first use. Every source
    exports ``gbnns_error_string(int)``, which ``check`` reads."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.gbnns_error_string.argtypes = [ctypes.c_int]
            lib.gbnns_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def aligned(t):
    """``t`` contiguous and 16-byte aligned, as the kernels' vector loads
    need (a copy only when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.gbnns_error_string(err).decode()}")


class LaunchCounts(dict):
    """Kernel launches per wrapper: each wrapper counts one where it launches
    its kernel, and nowhere else, so a run can show which kernels it used."""

    def __init__(self, *names: str):
        super().__init__({name: 0 for name in names})
        self._lock = threading.Lock()

    def count(self, name: str) -> None:
        with self._lock:
            self[name] += 1

    def reset(self) -> None:
        with self._lock:
            for name in self:
                self[name] = 0
