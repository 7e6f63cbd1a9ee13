"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch or
CUTLASS header, so one ``nvcc`` call builds it in seconds (a source that
includes PyTorch's headers takes minutes). The shared library goes to
``<repo>/.kernel_build/<name>-<hash>/``, keyed by a hash of the source and
the flags, so a second run reuses it. Nothing is built at import time: the
first wrapper call on a CUDA tensor builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / ".kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` is built: keyed by its source and flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, pathlib.Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build(names: list[str]) -> None:
    """Build every named source that is not built yet, one ``nvcc`` process
    per source, all started together. Raises with the compiler's output."""
    started = {name: _start_build(name) for name in names}
    errors = []
    for name, job in started.items():
        if job is None:
            continue
        proc, tmp = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, library_path(name))  # atomic: no half-written .so
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The built ``lib<name>.so``, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
