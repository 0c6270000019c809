"""The traced part of a window: a ``torch.profiler`` capture of the host and
the card, reduced in memory (no trace file is written).

Each request of the window runs inside a ``vsbench::request`` span; the
traced window runs from the first traced span's start to the last one's
end. Device operations are the profiler's CUDA events (kernels, copies,
sets; not the annotations that mirror host ranges); the device is busy
where any of them runs. An idle gap is named by
the innermost host operation that covers its middle.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch

SPAN = "vsbench::request"
# idle gaps named by their host operation: the longest ones
_NAMED_GAPS = 500
# entries of each breakdown list
_TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    n_requests: int
    n_queries: int
    # device operation name -> [count, seconds]
    ops: dict
    breakdown: dict

    def seconds(self, match=lambda name: True) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(s for name, (_, s) in self.ops.items() if match(name))

    def count(self) -> int:
        """Kernels launched (copies and sets left out)."""
        return sum(c for name, (c, _) in self.ops.items() if is_kernel(name))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def profiler(device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # one cycle; acc_events keeps it from warning that a new cycle would clear it
    return torch.profiler.profile(activities=acts, acc_events=True)


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof: torch.profiler.profile, n_queries: int) -> Summary:
    """Reduce a stopped capture whose requests ran in ``SPAN`` spans."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host, dev, spans = [], [], []
    for e in events:
        s, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            dev.append((s, s + dur, e.name()))
        elif dur > 0:
            (spans if e.name() == SPAN else host).append((s, s + dur, e.name()))
    if not spans:
        raise RuntimeError("the capture holds no request span")
    # a host range (``record_function``) also shows on the device's timeline
    # as an annotation: not an operation of the device
    ranges = {n for _, _, n in host} | {SPAN}
    dev = [d for d in dev if d[2] not in ranges]
    w0, w1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    ops = defaultdict(lambda: [0, 0.0])
    for s, e, n in dev:
        ops[n][0] += 1
        ops[n][1] += (e - s) * 1e-9
    busy = _union([(s, e) for s, e, _ in dev])
    busy_ns = sum(e - s for s, e in busy)
    # idle gaps inside the window, head and tail included
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    named = defaultdict(float)
    for length, name in zip([g[0] for g in gaps[:_NAMED_GAPS]],
                            _host_at(host, spans, [(s + e) // 2 for _, s, e in gaps[:_NAMED_GAPS]])):
        named[name] += length * 1e-9
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:_TOP]
    breakdown = {
        "device_ops": [[n[:200], v[1]] for n, v in top_ops],
        "idle_gaps": [[n[:200], v] for n, v in sorted(named.items(), key=lambda kv: -kv[1])[:_TOP]],
    }
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, n_requests=len(spans),
                   n_queries=n_queries, ops=dict(ops), breakdown=breakdown)


def _host_at(host, spans, times) -> list:
    """The innermost host operation running at each of ``times``: a sweep in
    time order over the operations, which nest, with a stack of the open
    ones. Where none is open: the request span, or the harness between
    requests."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    order = sorted(range(len(times)), key=lambda j: times[j])
    out = [None] * len(times)
    stack, i = [], 0
    for j in order:
        t = times[j]
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[j] = stack[-1][2]
        elif any(s <= t <= e for s, e, _ in spans):
            out[j] = SPAN
        else:
            out[j] = "vsbench::between_requests"
    return out
