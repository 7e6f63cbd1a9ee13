"""ctypes bindings for the C++/OpenMP reference engine (native/gbnns_ref.cpp).

Port of ``gbnns_tpu/native.py``, over the same sources and the same build:
the shared library is built on demand with ``make -C native`` (g++ and
OpenMP) into ``native/build/``, where either package loads it. It
re-implements the reference's native components (brute-force kNN build and
priority-queue beam search with an exact visited set) and serves as the
recall-parity oracle and the single-node CPU baseline. It imports neither
torch nor JAX.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libgbnns_ref.so")

_METRIC = {"l2": 0, "ip": 1, "angular": 1}


class NativeUnavailable(RuntimeError):
    pass


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    native_dir = os.path.abspath(_NATIVE_DIR)
    lib_path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(lib_path):
        if not os.path.exists(os.path.join(native_dir, "Makefile")):
            raise NativeUnavailable(f"native sources not found at {native_dir}")
        try:
            subprocess.run(["make", "-C", native_dir], check=True,
                           capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", str(e))
            raise NativeUnavailable(f"native build failed: {detail}") from e
    lib = ctypes.CDLL(lib_path)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c = ctypes.c_int
    lib.gbnns_knn_build.argtypes = [f32p, c, c, c, c, i32p]
    lib.gbnns_beam_search.argtypes = [f32p, c, c, i32p, c, f32p, c, c,
                                      i32p, c, c, i32p, f32p, i64p]
    lib.gbnns_rerank.argtypes = [f32p, c, c, f32p, c, i32p, c, c, c,
                                 i32p, f32p]
    lib.gbnns_num_threads.restype = c
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


def num_threads() -> int:
    return _lib().gbnns_num_threads()


def knn_build(base, K: int, *, metric: str = "l2") -> np.ndarray:
    base = np.ascontiguousarray(base, dtype=np.float32)
    n, d = base.shape
    out = np.empty((n, K), dtype=np.int32)
    _lib().gbnns_knn_build(base, n, d, K, _METRIC[metric], out)
    return out


def beam_search(base, graph, queries, entries, *, ef: int,
                metric: str = "l2"):
    """Returns (ids (nq, ef), dists (nq, ef), ndist (nq,)) ascending."""
    base = np.ascontiguousarray(base, dtype=np.float32)
    graph = np.ascontiguousarray(graph, dtype=np.int32)
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    entries = np.ascontiguousarray(entries, dtype=np.int32)
    n, d = base.shape
    nq = queries.shape[0]
    assert graph.shape[0] == n and queries.shape[1] == d
    ids = np.empty((nq, ef), dtype=np.int32)
    dists = np.empty((nq, ef), dtype=np.float32)
    ndist = np.empty((nq,), dtype=np.int64)
    _lib().gbnns_beam_search(base, n, d, graph, graph.shape[1], queries, nq,
                             ef, entries, entries.shape[0], _METRIC[metric],
                             ids, dists, ndist)
    return ids, dists, ndist


def rerank(base, queries, cand, k: int, *, metric: str = "l2"):
    base = np.ascontiguousarray(base, dtype=np.float32)
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    n, d = base.shape
    nq, C = cand.shape
    ids = np.empty((nq, k), dtype=np.int32)
    dists = np.empty((nq, k), dtype=np.float32)
    _lib().gbnns_rerank(base, n, d, queries, nq, cand, C, k,
                        _METRIC[metric], ids, dists)
    return ids, dists
