"""HTTP search service: a device-resident index behind a micro-batching
dispatcher.

Request threads enqueue queries; one dispatcher thread drains the queue
every ``max_wait_ms`` (or once ``max_batch`` queries are waiting), uploads
the coalesced batch once, runs ONE device batch and queues a copy of the
results into pinned host memory; a completer thread waits for each batch's
copy and answers its requests, so the next batch is issued while the last
one finishes. Stdlib only (``http.server``).

Start:  python -m gbnns_tpu_torch.cli serve --base base.fvecs
                    [--base-lo base_lo.fvecs | --proj proj.npz]
                    [--graph graph.npy [--centroids cents.npz]] --port 8390
Query:  curl -d '{"queries": [[...]], "k": 10}' localhost:8390/search

Two wire protocols (connections are HTTP/1.1 persistent):
  POST /search       JSON
  POST /search_raw   raw little-endian binary (``pack_raw_request`` /
                     ``unpack_raw_response``), byte-identical to the JAX
                     package's, so clients of either package interoperate

Lifetime: ``stop()`` wakes the dispatcher with a sentinel, joins both
threads and fails any request still queued. ``serve()`` runs the HTTP front
end until another thread calls ``shutdown()`` on the server it was given
(see ``make_server``), then closes it and stops the service.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device

_STOP = object()  # dispatcher / completer sentinel


class _Pending:
    __slots__ = ("queries", "queries_lo", "k", "event", "result", "error")

    def __init__(self, queries, queries_lo, k):
        self.queries = queries
        self.queries_lo = queries_lo
        self.k = k
        self.event = threading.Event()
        self.result: Any = None
        self.error: str | None = None

    def fail(self, error: str) -> None:
        self.error = error
        self.event.set()


class SearchService:
    """Device-resident index + micro-batching dispatcher.

    ``engine``: "fused" (binned-scan kernels + exact re-rank; ``c`` is the
    recall knob), "flat", "graph_pallas" (``GraphIndex``: the payload
    walker on kernel K3, centroid entries, re-rank; ``ef`` is the recall
    knob) or "graph" (the plain walker from strided entries, re-rank). The
    graph engines need ``graph``, the (n, K) adjacency; ``centroids_path``
    loads staged ``CentroidEntries`` for "graph_pallas" instead of fitting
    them. ``projection``: optional callable full-d → low-d applied to the
    uploaded query batch on the device.
    """

    def __init__(self, base, base_lo=None, graph=None, *, metric="l2",
                 engine: str = "flat", ef: int = 64, c: int = 64,
                 max_batch: int = 4096, max_wait_ms: float = 2.0,
                 projection=None, scan_dtype: str = "bfloat16",
                 centroids_path: str | None = None,
                 h2d_dtype: str = "float32", device=None):
        from gbnns_tpu_torch.search.flat import FlatIndex

        if engine not in ("flat", "fused", "graph", "graph_pallas"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine in ("graph", "graph_pallas") and graph is None:
            raise ValueError(f"engine={engine!r} requires a graph artifact")
        if h2d_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"h2d_dtype must be float32|bfloat16, "
                             f"got {h2d_dtype!r}")
        self.device = resolve_device(device)
        self.metric = metric
        self.engine = engine
        self.ef = ef
        self.c = c
        # "bfloat16" halves the query upload: the batch is rounded to bf16
        # on the host and cast back to f32 on the device
        self.h2d_dtype = h2d_dtype
        self.projection = projection
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._q: queue.Queue = queue.Queue()

        self.flat = FlatIndex(base, base_lo, metric=metric, device=self.device)
        self.fused = None
        self.gidx = None
        self.graph = None
        if engine == "fused":
            from gbnns_tpu_torch.kernels.scan_topk import FusedScanIndex

            # as in the JAX service: int8, else bf16
            self.fused = FusedScanIndex(
                base, base_lo, metric=metric,
                scan_dtype="int8" if scan_dtype == "int8" else "bfloat16",
                device=self.device)
        elif engine == "graph_pallas":
            from gbnns_tpu_torch.search.entries import CentroidEntries
            from gbnns_tpu_torch.search.graph_index import GraphIndex

            entries = (CentroidEntries.load(centroids_path,
                                            device=self.device)
                       if centroids_path else None)
            self.gidx = GraphIndex.build(
                base, base_lo, metric=metric,
                ncent=max(64, min(4096, np.asarray(base).shape[0] // 256)),
                graph=np.asarray(graph, np.int32), entries=entries,
                device=self.device)
        elif engine == "graph":
            from gbnns_tpu_torch.search.walker import default_entry_ids

            self.graph = torch.tensor(np.asarray(graph, np.int32),
                                      device=self.device)
            self.base_lo_f32 = torch.from_numpy(np.asarray(
                base if base_lo is None else base_lo, np.float32)
            ).to(self.device)
            # never more entries than the pool: a search uses max(ef, k)
            self.entries = default_entry_ids(self.graph.shape[0],
                                             min(32, ef)).to(self.device)
        self._d_full = np.asarray(base).shape[1]
        self._d_lo = (np.asarray(base_lo).shape[1]
                      if base_lo is not None else None)
        # a first search builds the kernels (nvcc, seconds) before traffic
        dq = np.zeros((8, self._d_full), np.float32)
        dlo = (np.zeros((8, self._d_lo), np.float32)
               if self._d_lo is not None and projection is None else None)
        self._search(dq, dlo, 1)

        # bounded depth = backpressure on the dispatcher
        self._inflight: queue.Queue = queue.Queue(maxsize=4)
        # daemon threads cannot hold the interpreter open if a caller never
        # calls stop(); stop() joins them
        self._dispatcher = threading.Thread(target=self._run, daemon=True,
                                            name="gbnns-dispatch")
        self._completer = threading.Thread(target=self._complete, daemon=True,
                                           name="gbnns-complete")
        self._dispatcher.start()
        self._completer.start()

    def warm(self, k: int = 10, *, with_lo: bool | None = None) -> int:
        """Run one search at every request-size bucket up to ``max_batch``
        so first-use costs (allocator growth, cuBLAS handles) land before
        traffic. Returns the number of buckets warmed."""
        if with_lo is None:
            with_lo = self._d_lo is not None and self.projection is None
        bucket, warmed = 256, 0
        while bucket <= self.max_batch:
            q = np.zeros((bucket, self._d_full), np.float32)
            qlo = (np.zeros((bucket, self._d_lo), np.float32)
                   if with_lo else None)
            self._search(q, qlo, k)
            warmed += 1
            bucket *= 2
        return warmed

    def submit(self, queries: np.ndarray, queries_lo, k: int,
               timeout: float = 30.0):
        """Search from any thread: ``(ids (m, k) int32, dists (m, k) f32)``
        as numpy arrays."""
        if not self._dispatcher.is_alive():
            raise RuntimeError("service is stopped")
        p = _Pending(queries, queries_lo, k)
        self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("search timed out")
        if p.error:
            raise RuntimeError(p.error)
        return p.result

    def _drain(self) -> list[_Pending] | None:
        """The next batch of compatible requests; None once stopped."""
        first = self._q.get()
        if first is _STOP:
            return None
        batch = [first]
        has_lo = first.queries_lo is not None
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        total = first.queries.shape[0]
        deferred = []
        while total < self.max_batch and time.perf_counter() < deadline:
            try:
                p = self._q.get(timeout=max(0.0, deadline - time.perf_counter()))
            except queue.Empty:
                break
            if p is _STOP:
                deferred.append(p)  # exit after this batch
                break
            # only coalesce requests of the same shape-kind: mixing
            # with-queries_lo and without would search the wrong space
            if (p.queries_lo is not None) != has_lo \
                    or p.queries.shape[1] != first.queries.shape[1]:
                deferred.append(p)
                continue
            batch.append(p)
            total += p.queries.shape[0]
        for p in deferred:  # the next dispatcher cycle picks these up
            self._q.put(p)
        return batch

    def _run(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while True:
                batch = self._drain()
                if batch is None:
                    break
                try:
                    qs = np.concatenate([p.queries for p in batch])
                    qlos = (np.concatenate([p.queries_lo for p in batch])
                            if batch[0].queries_lo is not None else None)
                    k = max(p.k for p in batch)
                    ids, dists, m = self._search_device(qs, qlos, k)
                    ready = self._to_host(ids, dists)
                except Exception as e:  # deliver dispatch errors to waiters
                    for p in batch:
                        p.fail(f"{type(e).__name__}: {e}")
                    continue
                self._inflight.put((batch, ready, m))
        finally:
            self._inflight.put(_STOP)  # the completer ends after the last batch

    def _to_host(self, ids, dists):
        """Queue the device→host copy right behind the batch's work:
        ``(ids_host, dists_host, event)``; the event is None on the CPU."""
        if self.device.type != "cuda":
            return ids, dists, None
        ids_h = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        dists_h = torch.empty(dists.shape, dtype=dists.dtype, pin_memory=True)
        ids_h.copy_(ids, non_blocking=True)
        dists_h.copy_(dists, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return ids_h, dists_h, event

    def _complete(self):
        while True:
            item = self._inflight.get()
            if item is _STOP:
                break
            batch, (ids, dists, event), m = item
            try:
                if event is not None:
                    event.synchronize()  # this batch's copy has landed
                ids = ids.numpy()[:m]
                dists = dists.numpy()[:m]
                off = 0
                for p in batch:
                    n = p.queries.shape[0]
                    p.result = (ids[off:off + n, :p.k],
                                dists[off:off + n, :p.k])
                    off += n
                    p.event.set()
            except Exception as e:  # deliver errors to waiters
                for p in batch:
                    p.fail(f"{type(e).__name__}: {e}")

    def _search(self, queries, queries_lo, k):
        ids, dists, m = self._search_device(queries, queries_lo, k)
        return ids[:m].cpu().numpy(), dists[:m].cpu().numpy()

    @torch.no_grad()
    def _search_device(self, queries, queries_lo, k):
        # shape bucketing: pad the batch to the next power of two (min 256)
        # with repeated rows, so a service sees a few batch shapes only;
        # the padding is sliced off the results
        m = queries.shape[0]
        bucket = 256
        while bucket < m:
            bucket *= 2
        if bucket != m:
            pad = bucket - m
            queries = np.concatenate(
                [queries, np.repeat(queries[-1:], pad, axis=0)])
            if queries_lo is not None:
                queries_lo = np.concatenate(
                    [queries_lo, np.repeat(queries_lo[-1:], pad, axis=0)])
        # ONE host->device upload per dispatch; projection runs on device
        up = torch.bfloat16 if self.h2d_dtype == "bfloat16" else torch.float32
        qt = self._upload(queries, up)
        qlo = None if queries_lo is None else self._upload(queries_lo, up)
        if qlo is None and self.projection is not None:
            qlo = self.projection(qt)
        ids, dists = self._search_exact(qt, qlo, k)
        return ids, dists, m

    def _upload(self, a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)
        return t.to(self.device, non_blocking=False).float()

    def _search_exact(self, queries, queries_lo, k):
        if self.engine == "fused":
            # merge=None: kernel K2 on the card, the exact sort on the CPU
            return self.fused.search(queries, queries_lo, k=k,
                                     c=max(self.c, k), merge=None)
        ef = max(self.ef, k)
        if self.engine == "graph_pallas":
            return self.gidx.search(queries, queries_lo, k=k, ef=ef,
                                    num_entries=min(16, ef))
        if self.engine == "graph":
            from gbnns_tpu_torch.search.rerank import rerank
            from gbnns_tpu_torch.search.walker import beam_search

            res = beam_search(queries if queries_lo is None else queries_lo,
                              self.base_lo_f32, self.graph, self.entries,
                              ef=ef, metric=self.metric)
            return rerank(queries, self.flat.base_full, res.ids, k,
                          metric=self.metric,
                          base_sqnorms=self.flat.base_full_sqnorms)
        return self.flat.search(queries, queries_lo, k=k, c=max(self.c, k))

    def stop(self, timeout: float = 5.0) -> None:
        """Wake and join the dispatcher and completer, and fail whatever
        requests are still queued. Idempotent."""
        if self._dispatcher.is_alive():
            self._q.put(_STOP)
        self._dispatcher.join(timeout)
        self._completer.join(timeout)
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if p is not _STOP:
                p.fail("RuntimeError: service stopped")
        if self._dispatcher.is_alive() or self._completer.is_alive():
            raise RuntimeError("service threads did not stop in time")


RAW_MAGIC = 0x47424E31  # "GBN1": raw little-endian binary search protocol


def pack_raw_request(queries: np.ndarray, k: int) -> bytes:
    """Client-side encoder for POST /search_raw: 16-byte header
    (magic, n, d, k int32 LE) + n*d float32 LE query vectors."""
    q = np.ascontiguousarray(queries, dtype="<f4")
    hdr = np.array([RAW_MAGIC, q.shape[0], q.shape[1], k], dtype="<i4")
    return hdr.tobytes() + q.tobytes()


def unpack_raw_response(body: bytes):
    """Client-side decoder: (ids (n,k) int32, dists (n,k) f32)."""
    n, k = np.frombuffer(body[:8], dtype="<i4")
    ids = np.frombuffer(body[8:8 + 4 * n * k], dtype="<i4").reshape(n, k)
    dists = np.frombuffer(body[8 + 4 * n * k:], dtype="<f4").reshape(n, k)
    return ids, dists


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1: persistent connections (every reply carries
        # Content-Length, so keep-alive is safe)
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_raw(self, payload: bytes):
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "n": int(service.flat.base_full.shape[0]),
                                  "engine": service.engine})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/search_raw":
                # body layout documented at pack_raw_request /
                # unpack_raw_response
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    if length < 16:
                        raise ValueError("raw body too short")
                    magic, n, d, k = np.frombuffer(body[:16], dtype="<i4")
                    if magic != RAW_MAGIC:
                        raise ValueError("bad magic (expected GBN1)")
                    if n <= 0 or d <= 0 or not 0 < k <= 1024:
                        raise ValueError(f"bad raw header n={n} d={d} k={k}")
                    d_index = int(service.flat.base_full.shape[1])
                    if d != d_index:
                        raise ValueError(f"query dim {d} != index dim "
                                         f"{d_index}")
                    if length != 16 + 4 * n * d:
                        raise ValueError("raw body length mismatch")
                    queries = np.frombuffer(body[16:], dtype="<f4") \
                        .reshape(n, d)
                    ids, dists = service.submit(queries, None, int(k))
                    hdr = np.array([ids.shape[0], ids.shape[1]], dtype="<i4")
                    self._reply_raw(
                        hdr.tobytes()
                        + np.ascontiguousarray(ids, dtype="<i4").tobytes()
                        + np.ascontiguousarray(dists, dtype="<f4").tobytes())
                except (ValueError, TypeError) as e:
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path != "/search":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                queries = np.asarray(req["queries"], dtype=np.float32)
                if queries.ndim != 2:
                    raise ValueError("queries must be (n, d)")
                if queries.shape[0] == 0:
                    # pad-by-repeat has no row to repeat
                    raise ValueError("empty query batch")
                k = int(req.get("k", 10))
                qlo = req.get("queries_lo")
                qlo = np.asarray(qlo, np.float32) if qlo is not None else None
                t0 = time.perf_counter()
                ids, dists = service.submit(queries, qlo, k)
                self._reply(200, {
                    "ids": np.asarray(ids).tolist(),
                    "dists": np.asarray(dists, dtype=np.float64).tolist(),
                    "took_ms": round((time.perf_counter() - t0) * 1e3, 2),
                })
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(service: SearchService, port: int = 8390,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """The HTTP front end, bound but not yet serving (port 0 picks a free
    one: ``server.server_address[1]``)."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def serve(service: SearchService, port: int = 8390, host: str = "127.0.0.1",
          *, httpd: ThreadingHTTPServer | None = None) -> None:
    """Serve until interrupted, or until another thread calls
    ``httpd.shutdown()`` on the server passed in; then close the socket and
    stop the service."""
    if httpd is None:
        httpd = make_server(service, port, host)
    host, port = httpd.server_address[:2]
    print(f"gbnns serving on http://{host}:{port} "
          f"(engine={service.engine})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.stop()
