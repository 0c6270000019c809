"""Tracing annotations — port of ``cuvs_tpu.utils.tracing``.

``traced(name)`` wraps a public entry point in a
``torch.profiler.record_function`` range (visible in ``torch.profiler``
traces, the NVTX-range analog) and, with ``CUVS_TPU_TRACE=1``, logs its
host wall time. ``start_profiler_trace`` / ``stop_profiler_trace`` bracket a
``torch.profiler`` trace of the host and, where there is one, the CUDA card
(the reference's ``jax.profiler`` trace), written as a Chrome trace.
"""

from __future__ import annotations

import functools
import logging
import os
import time

import torch

logger = logging.getLogger("cuvs_tpu_torch")


def traced(name: str):
    """Decorator: record_function range + optional wall-time log."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with torch.profiler.record_function(name):
                if os.environ.get("CUVS_TPU_TRACE"):
                    t0 = time.perf_counter()
                    out = fn(*args, **kw)
                    logger.info("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)
                    return out
                return fn(*args, **kw)

        return wrapper

    return deco


# the one trace in progress (the reference's jax.profiler keeps one per process too)
_TRACE: dict = {}


def start_profiler_trace(log_dir: str) -> None:
    """Begin a trace of the host and CUDA activity (view the file that
    ``stop_profiler_trace`` writes in Perfetto or chrome://tracing)."""
    if _TRACE:
        raise RuntimeError("a profiler trace is already running")
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
