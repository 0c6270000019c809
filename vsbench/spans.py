"""Readings of the port's own stage spans and counters
(``cuvs_tpu_torch.utils.tracing``), which it records while the traced
requests run under the profiler: the span readers of ``vsbench/metrics/``
share them. A port that keeps no such records gives None everywhere, and its
metrics are left out of the line."""

from __future__ import annotations

from cuvs_tpu_torch.utils import tracing

# the names of the spans that open a request's search or build call
ENTRIES = ("::search", "::build")


def records(run):
    """The span records of the run's traced requests; None where the program
    keeps none, or where they do not match the requests: each request of a
    mix makes exactly one outermost ``*::search`` or ``*::build`` call
    (refine, the SIFT cells' second call, is neither)."""
    t = run.trace
    read = getattr(tracing, "spans", None)
    if t is None or not t.n_requests or read is None:
        return None
    found = read()
    calls = sum(s.parent is None and s.name.endswith(ENTRIES) for s in found)
    return found if calls == t.n_requests else None


def stream_ms(run, name: str):
    """Stream ms per traced request of the spans named ``name``;
    None without such a span, or without a device (``stream_ms`` None)."""
    found = records(run)
    times = [s.stream_ms for s in found or () if s.name == name]
    if not times or None in times:
        return None
    return sum(times) / run.trace.n_requests


def counted(run, counter: str, name: str):
    """The sum of ``counter`` over the spans whose name ends in ``name``
    (None: no such span holds it)."""
    found = [s.counts[counter] for s in records(run) or ()
             if s.name.endswith(name) and counter in s.counts]
    return sum(found) if found else None
