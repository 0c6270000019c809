"""Tracing: stage spans and counters, and whole-process profiler traces —
port of ``cuvs_tpu.utils.tracing``.

Recording is on exactly while a ``torch.profiler`` capture runs
(``start_profiler_trace``, or any ``torch.profiler.profile``) and off
otherwise; there is no other switch.

``span(name)`` marks one stage of a call as a context manager, and
``traced(name)`` is its decorator form, which wraps the public entry points.
While off, a span costs one flag test: no profiler range, no clock read, no
CUDA event, no record. While on, it opens a ``torch.profiler.record_function``
range (so the capture's device trace names the span, the analog of cuVS's
NVTX ranges) and keeps one record in memory (``Span``):

- ``name``, ``id``, ``parent`` (the innermost span open when it began, or
  None) and ``request`` (the outermost one: the spans of one call share it);
- ``host_start_ns`` / ``host_end_ns``: the host clock (``time.time_ns``, the
  clock of the capture's events) inside the span's profiler range;
- ``stream_ms``: a CUDA event pair on the current stream of the current
  device, recorded as the span begins and ends. It is the stream's time from
  finishing the work queued before the span to finishing the span's own work,
  idle time inside the span included: the span's share of a request on the
  device. None where the process has not initialised CUDA;
- ``counts``: what ``count(name, n)`` added while it was the innermost span.

``count(name, n)`` takes a host integer only: a counter never reads the
device.

Per-stage times of one's own searches::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ivf_pq.search(index, queries, 10, params)
    torch.cuda.synchronize()
    for s in tracing.spans():  # ivf_pq::search, ivf::coarse_search, ivf::group, ...
        print(s.name, s.stream_ms, s.counts)

Records accumulate across captures until ``clear()`` (which
``start_profiler_trace`` calls). ``start_profiler_trace`` /
``stop_profiler_trace`` bracket a ``torch.profiler`` trace of the host and,
where there is one, the CUDA card (the reference's ``jax.profiler`` trace),
written as a Chrome trace.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import threading
import time
from typing import Optional

import torch
# the flag that every profiler front end sets while it captures (the one that
# ``record_function`` itself consults)
from torch._C._autograd import _profiler_enabled


@dataclasses.dataclass
class Span:
    """One finished span (see the module's docstring)."""

    name: str
    id: int
    parent: Optional[int]
    request: int
    host_start_ns: int
    host_end_ns: int
    stream_ms: Optional[float]
    counts: dict


# every span entered while recording, in the order they began
_RECORDS: list = []
_IDS = itertools.count()
# .stack: the spans open in this thread, outermost first
_LOCAL = threading.local()


def _open() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _stream_event():
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Off:
    """The span while nothing records: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recording:
    __slots__ = ("name", "id", "parent", "request", "t0", "t1", "ev0", "ev1", "stream_ms",
                 "counts", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open()
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.request = stack[0].id if stack else self.id
        self.counts = {}
        self.t1 = self.ev1 = self.stream_ms = None
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.time_ns()
        self.ev0 = _stream_event()
        stack.append(self)
        _RECORDS.append(self)
        return self

    def __exit__(self, *exc):
        if self.ev0 is not None:
            self.ev1 = _stream_event()
        self.t1 = time.time_ns()
        _open().remove(self)
        self._range.__exit__(*exc)
        return False

    def finished(self) -> Span:
        if self.ev1 is not None:  # resolved once; the events go
            self.ev1.synchronize()
            self.stream_ms = self.ev0.elapsed_time(self.ev1)
            self.ev0 = self.ev1 = None
        return Span(self.name, self.id, self.parent, self.request, self.t0, self.t1,
                    self.stream_ms, dict(self.counts))


def recording() -> bool:
    """Whether spans and counters record now (a profiler capture runs)."""
    return _profiler_enabled()


def span(name: str):
    """Context manager over one stage of a call (see the module's docstring)."""
    if not _profiler_enabled():
        return _OFF
    return _Recording(name)


def traced(name: str):
    """Decorator: the whole call is one ``span(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with span(name):
                return fn(*args, **kw)

        return wrapper

    return deco


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the innermost open span's ``counts``
    (nothing while no capture runs, or no span is open)."""
    if not _profiler_enabled():
        return
    if isinstance(n, torch.Tensor):
        raise TypeError(f"count {name!r}: a host integer, not a tensor (reading one waits "
                        "for the device)")
    stack = _open()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + int(n)


def spans() -> list:
    """The finished spans, in the order they began, as ``Span`` records.
    ``stream_ms`` is worked out here: call it after a device synchronise."""
    return [r.finished() for r in _RECORDS if r.t1 is not None]


def clear() -> None:
    """Forget every record."""
    _RECORDS.clear()


# the one trace in progress (the reference's jax.profiler keeps one per process too)
_TRACE: dict = {}


def start_profiler_trace(log_dir: str) -> None:
    """Begin a trace of the host and CUDA activity (view the file that
    ``stop_profiler_trace`` writes in Perfetto or chrome://tracing). The
    span records start anew."""
    if _TRACE:
        raise RuntimeError("a profiler trace is already running")
    clear()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # one cycle; acc_events keeps it from warning that a new cycle would clear it
    prof = torch.profiler.profile(activities=activities, acc_events=True)
    prof.start()
    _TRACE.update(prof=prof, log_dir=log_dir)


def stop_profiler_trace() -> str:
    """End the trace and write it as ``<log_dir>/trace_<pid>_<ns>.json``
    (Chrome trace format); returns that path."""
    if not _TRACE:
        raise RuntimeError("no profiler trace is running")
    prof, log_dir = _TRACE.pop("prof"), _TRACE.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
