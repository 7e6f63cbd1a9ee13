"""TEXMEX vector-file codecs (.fvecs / .ivecs / .bvecs).

Capability parity: the reference's Python readers and C++ loaders for the
standard ANN-benchmark file format (SURVEY.md §3 "fvecs/ivecs codec";
BASELINE.json:7-11 datasets all ship in this format). Format: each record is a
little-endian int32 dimension ``d`` followed by ``d`` payload elements
(float32 for .fvecs, int32 for .ivecs, uint8 for .bvecs).

Files are decoded on the host with zero-copy numpy memmaps (one
``np.memmap`` view reinterpreted as ``(n, d+hdr)`` records, the header
column sliced off) so multi-GB base sets never double-buffer in host RAM;
the indexes copy them to the device. A streaming chunk reader feeds chunked
consumers without materializing the full array.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

_DTYPES = {
    ".fvecs": (np.float32, 4),
    ".ivecs": (np.int32, 4),
    ".bvecs": (np.uint8, 1),
}


def _spec_for(path: str) -> tuple[np.dtype, int]:
    ext = os.path.splitext(path)[1]
    if ext not in _DTYPES:
        raise ValueError(f"unsupported vector-file extension {ext!r} (want .fvecs/.ivecs/.bvecs)")
    dtype, itemsize = _DTYPES[ext]
    return np.dtype(dtype), itemsize


def vecs_dim(path: str) -> int:
    """Read the per-record dimension from the first 4-byte header."""
    with open(path, "rb") as f:
        hdr = f.read(4)
    if len(hdr) < 4:
        raise ValueError(f"{path}: too short to contain a record header")
    d = int(np.frombuffer(hdr, dtype="<i4")[0])
    if d <= 0:
        raise ValueError(f"{path}: invalid record dimension {d}")
    return d


def vecs_count(path: str) -> int:
    """Number of records, derived from file size (validates uniform records)."""
    d = vecs_dim(path)
    _, itemsize = _spec_for(path)
    rec_bytes = 4 + d * itemsize
    size = os.path.getsize(path)
    if size % rec_bytes != 0:
        raise ValueError(f"{path}: size {size} not a multiple of record size {rec_bytes}")
    return size // rec_bytes


def read_vecs(path: str, *, mmap: bool = True, count: int | None = None,
              offset: int = 0) -> np.ndarray:
    """Read an (n, d) array from a TEXMEX vector file.

    ``mmap=True`` returns a view into a read-only memmap (no copy); the header
    column is sliced off so the result is not C-contiguous — call
    ``np.ascontiguousarray`` if a packed buffer is required.
    ``offset``/``count`` select a record range (for streaming).
    """
    dtype, itemsize = _spec_for(path)
    d = vecs_dim(path)
    n_total = vecs_count(path)
    if offset < 0 or offset > n_total:
        raise ValueError(f"offset {offset} out of range [0, {n_total}]")
    n = n_total - offset if count is None else min(count, n_total - offset)
    # A record is 4 header bytes + d payload bytes; view the whole file as
    # bytes, reshape to records, then reinterpret the payload region.
    rec_bytes = 4 + d * itemsize
    if mmap:
        raw = np.memmap(path, dtype=np.uint8, mode="r",
                        offset=offset * rec_bytes, shape=(n, rec_bytes))
    else:
        with open(path, "rb") as f:
            f.seek(offset * rec_bytes)
            raw = np.frombuffer(f.read(n * rec_bytes), dtype=np.uint8)
        raw = raw.reshape(n, rec_bytes)
    payload = raw[:, 4:]
    if mmap:
        out = payload.view(dtype).reshape(n, d)
    else:
        out = np.ascontiguousarray(payload).view(dtype).reshape(n, d)
    return out


def iter_vecs(path: str, chunk: int = 100_000) -> Iterator[np.ndarray]:
    """Stream records in chunks of ``chunk`` rows (each a contiguous copy)."""
    n = vecs_count(path)
    for off in range(0, n, chunk):
        yield np.ascontiguousarray(read_vecs(path, count=min(chunk, n - off), offset=off))


def write_vecs(path: str, arr: np.ndarray) -> None:
    """Write an (n, d) array as a TEXMEX vector file (extension picks dtype)."""
    dtype, _ = _spec_for(path)
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError(f"expected (n, d) array, got shape {arr.shape}")
    n, d = arr.shape
    payload = np.ascontiguousarray(arr, dtype=dtype)
    hdr = np.full((n, 1), d, dtype="<i4")
    with open(path, "wb") as f:
        # Interleave header+payload per record via a byte view.
        rec = np.empty((n, 4 + d * payload.itemsize), dtype=np.uint8)
        rec[:, :4] = hdr.view(np.uint8).reshape(n, 4)
        rec[:, 4:] = payload.view(np.uint8).reshape(n, d * payload.itemsize)
        rec.tofile(f)


# Convenience aliases matching the conventional API names.
def read_fvecs(path: str, **kw) -> np.ndarray:
    return read_vecs(path, **kw)


def read_ivecs(path: str, **kw) -> np.ndarray:
    return read_vecs(path, **kw)


def read_bvecs(path: str, **kw) -> np.ndarray:
    return read_vecs(path, **kw)


def write_fvecs(path: str, arr: np.ndarray) -> None:
    write_vecs(path, np.asarray(arr, dtype=np.float32))


def write_ivecs(path: str, arr: np.ndarray) -> None:
    write_vecs(path, np.asarray(arr, dtype=np.int32))
