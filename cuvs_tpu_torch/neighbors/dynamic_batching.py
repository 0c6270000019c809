"""Dynamic batching: cross-request query aggregation for serving — port of
``cuvs_tpu.neighbors.dynamic_batching``.

``cuvs::neighbors::dynamic_batching`` (dynamic_batching.hpp:24-55:
max_batch_size=100, n_queues=3, dispatch_timeout_ms, conservative dispatch).
Request threads submit query rows; one dispatcher collects them until
``max_batch_size`` rows or ``dispatch_timeout_ms`` elapse, searches the
batch in one call on the wrapped index's device, and resolves each
request's future with its rows of the result as host numpy arrays.

Two queues: ``native`` (the default; ``auto`` means it) is the MPSC ring of
``native/batch_queue.cpp`` in the port's host library (``io.native``), built
at first use; ``python`` is a condition-variable queue. A batch is searched
at the size it has: the reference pads it to ``max_batch_size`` so its jitted
search keeps one shape, which PyTorch does not need.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BatchParams:
    """Mirrors dynamic_batching::index_params (dynamic_batching.hpp:24-55).

    ``auto_tune`` adapts the dispatch timeout from measured service latency
    (not in cuVS, which exposes the raw knob only): waiting up to
    ``auto_tune_fraction`` of the observed median search time bounds the
    queueing delay at that fraction while letting the batch fill toward
    max_batch_size. If ``target_latency_ms`` is set the timeout also backs
    off whenever the rolling p95 end-to-end latency exceeds the target.
    """

    k: int = 10
    max_batch_size: int = 100
    dispatch_timeout_ms: float = 2.0
    conservative_dispatch: bool = False
    auto_tune: bool = False
    auto_tune_fraction: float = 0.5
    target_latency_ms: Optional[float] = None


class _TuneState:
    """Rolling latency stats + the adapted dispatch timeout (shared by both
    queue backends)."""

    def __init__(self, params: BatchParams):
        self.params = params
        self.timeout_s = params.dispatch_timeout_ms / 1000.0
        self._mu = threading.Lock()
        self._service: List[float] = []  # per-dispatch search seconds
        self._e2e: List[float] = []      # per-request end-to-end seconds
        self._batch_rows: List[int] = []  # rows per dispatched batch

    def record(self, service_s: float, e2e: List[float], rows: int) -> None:
        with self._mu:
            self._service = (self._service + [service_s])[-64:]
            self._e2e = (self._e2e + e2e)[-512:]
            self._batch_rows = (self._batch_rows + [rows])[-512:]
            if not self.params.auto_tune:
                return
            med = float(np.median(self._service))
            t = self.params.auto_tune_fraction * med
            tgt = self.params.target_latency_ms
            if tgt is not None and len(self._e2e) >= 8:
                p95 = float(np.percentile(self._e2e, 95))
                if p95 > tgt / 1000.0:
                    t = min(t, self.timeout_s * 0.5)
            # never below 0.1 ms, never above 50x the configured timeout (a
            # user-set long fill window is honored, not snapped to a cap)
            cfg = self.params.dispatch_timeout_ms / 1000.0
            lo = min(1e-4, cfg)
            hi = max(0.1, cfg * 50.0)
            self.timeout_s = float(np.clip(t, lo, hi))

    def stats(self) -> dict:
        with self._mu:
            e = np.asarray(self._e2e) * 1000.0
            s = np.asarray(self._service) * 1000.0
            b = np.asarray(self._batch_rows)
            return {
                "dispatch_timeout_ms": self.timeout_s * 1000.0,
                "n_requests": int(e.size),
                "latency_p50_ms": float(np.percentile(e, 50)) if e.size else None,
                "latency_p95_ms": float(np.percentile(e, 95)) if e.size else None,
                "service_p50_ms": float(np.percentile(s, 50)) if s.size else None,
                "max_batch_rows": int(b.max()) if b.size else None,
            }


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class BatchedSearcher:
    """Wraps a search function in a request-aggregating queue.

    ``search_fn(queries [B, d] numpy) -> (dists [B, k], ids [B, k])``, tensors
    or arrays; ``submit`` returns a Future per request. ``backend``: "auto"
    and "native" use the host library's MPSC ring, "python" the condvar
    queue."""

    def __init__(self, search_fn: Callable, dim: int, params: BatchParams = BatchParams(),
                 backend: str = "auto"):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"backend {backend!r}: auto, native or python")
        self.search_fn = search_fn
        self.params = params
        self.dim = dim
        self._native = None
        if backend in ("auto", "native"):
            from cuvs_tpu_torch.io import native

            self._native = _NativeBackend(native.lib(), search_fn, dim, params)
            return
        self._tune = _TuneState(params)
        self._lock = threading.Condition()
        self._pending: List[Tuple[np.ndarray, Future, float]] = []
        self._rows = 0
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, queries) -> Future:
        """Enqueue [m, d] queries; resolves to (dists [m, k], ids [m, k])."""
        queries = np.asarray(_host(queries), np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if queries.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {queries.shape[1]}")
        if self._native is not None:
            return self._native.submit(queries)
        fut = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("searcher closed")
            self._pending.append((queries, fut, time.monotonic()))
            self._rows += queries.shape[0]
            self._lock.notify()
        return fut

    def search(self, queries, timeout: Optional[float] = 30.0):
        """Blocking convenience wrapper."""
        return self.submit(queries).result(timeout=timeout)

    def _run(self):
        B = self.params.max_batch_size
        while True:
            with self._lock:
                if not self._pending:
                    self._lock.wait(timeout=0.1)
                    if self._closed and not self._pending:
                        return
                    continue
                deadline = time.monotonic() + self._tune.timeout_s
                while self._rows < B and time.monotonic() < deadline:
                    self._lock.wait(timeout=max(0.0, deadline - time.monotonic()))
                batch = self._pending
                self._pending = []
                self._rows = 0
            self._dispatch(batch, B)

    def _dispatch(self, batch, B):
        try:
            qs = np.concatenate([q for q, _, _ in batch], axis=0)
            t0 = time.monotonic()
            outs_d, outs_i = [], []
            for s in range(0, qs.shape[0], B):
                d, i = self.search_fn(qs[s:s + B])
                outs_d.append(_host(d))
                outs_i.append(_host(i))
            service = time.monotonic() - t0
            all_d = np.concatenate(outs_d, axis=0)
            all_i = np.concatenate(outs_i, axis=0)
            off = 0
            now = time.monotonic()
            for q, fut, _ in batch:
                m = q.shape[0]
                fut.set_result((all_d[off:off + m], all_i[off:off + m]))
                off += m
            self._tune.record(service, [now - ts for _, _, ts in batch], min(B, qs.shape[0]))
        except Exception as e:  # propagate to every waiter
            for _, fut, _ in batch:
                if not fut.done():
                    fut.set_exception(e)

    def stats(self) -> dict:
        """Rolling latency stats, the (auto-tuned) dispatch timeout and the
        largest batch dispatched."""
        tune = self._native._tune if self._native is not None else self._tune
        return tune.stats()

    def close(self):
        if self._native is not None:
            self._native.close()
            return
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._worker.join(timeout=5.0)


class _NativeBackend:
    """Dispatcher over the host library's MPSC ring (native/batch_queue.cpp):
    request threads push rows tagged with a ticket; one dispatcher pops a
    contiguous batch (capacity or dispatch timeout), searches, and resolves
    futures as each ticket's rows complete."""

    def __init__(self, lib, search_fn, dim, params):
        self.lib = lib
        self.search_fn = search_fn
        self.dim = dim
        self.params = params
        self.q = lib.cuvs_tpu_queue_create(max(params.max_batch_size * 4, 512), dim)
        self._tune = _TuneState(params)
        self._mu = threading.Lock()
        self._next_ticket = 0
        self._inflight = {}  # ticket -> [n_rows, Future, rows_d, rows_i, filled, t_submit]
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, queries) -> Future:
        fut = Future()
        m, k = queries.shape[0], self.params.k
        with self._mu:
            if self._closed:
                raise RuntimeError("searcher closed")
            ticket = self._next_ticket
            self._next_ticket += 1
            self._inflight[ticket] = [m, fut, np.empty((m, k), np.float32),
                                      np.empty((m, k), np.int32), 0, time.monotonic()]
        rows = np.ascontiguousarray(queries, np.float32)
        pushed = self.lib.cuvs_tpu_queue_push(self.q, rows.ctypes.data_as(ctypes.c_void_p), m,
                                              ticket)
        if pushed != m:
            with self._mu:
                self._inflight.pop(ticket, None)
            fut.set_exception(RuntimeError("queue closed during push"))
        return fut

    def _run(self):
        B = self.params.max_batch_size
        out = np.empty((B, self.dim), np.float32)
        tickets = np.empty(B, np.int64)
        while True:
            timeout_us = int(self._tune.timeout_s * 1e6)
            n = self.lib.cuvs_tpu_queue_pop_batch(
                self.q, out.ctypes.data_as(ctypes.c_void_p),
                tickets.ctypes.data_as(ctypes.c_void_p), B, timeout_us)
            if n == 0:
                if self._closed and self.lib.cuvs_tpu_queue_size(self.q) == 0:
                    return
                continue
            try:
                t0 = time.monotonic()
                d, i = self.search_fn(out[:n].copy())
                d, i = _host(d)[:n], _host(i)[:n]
                service = time.monotonic() - t0
                err = None
            except Exception as e:  # noqa: BLE001
                err = e
            done = []
            with self._mu:
                for r in range(n):
                    t = int(tickets[r])
                    ent = self._inflight.get(t)
                    if ent is None:
                        continue
                    if err is not None:
                        if not ent[1].done():
                            ent[1].set_exception(err)
                        self._inflight.pop(t, None)
                        continue
                    pos = ent[4]
                    ent[2][pos] = d[r]
                    ent[3][pos] = i[r]
                    ent[4] += 1
                    if ent[4] == ent[0]:
                        done.append((ent[1], ent[2], ent[3], ent[5]))
                        self._inflight.pop(t, None)
            now = time.monotonic()
            for fut, dd, ii, _ in done:
                fut.set_result((dd, ii))
            if err is None and done:
                self._tune.record(service, [now - ts for _, _, _, ts in done], int(n))

    def close(self):
        with self._mu:
            self._closed = True
        self.lib.cuvs_tpu_queue_close(self.q)
        self._worker.join(timeout=5.0)
        self.lib.cuvs_tpu_queue_destroy(self.q)
        self.q = None


def wrap(module, index, dim: int, params: BatchParams = BatchParams(), backend: str = "auto",
         **search_kw) -> BatchedSearcher:
    """A BatchedSearcher over any index module (the ``dynamic_batching::index``
    analog: wraps an upstream index); the search runs on the index's device."""

    def fn(queries):
        return module.search(index, queries, params.k, **search_kw)

    return BatchedSearcher(fn, dim, params, backend=backend)
