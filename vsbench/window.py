"""The measured window: a closed loop of one client that calls a request
after request until ``seconds`` have passed on the host clock, and lets the
request that crosses the limit finish. Each request's time runs from its
call to its result, synchronised with the device, on the host clock; the
window ends in a device synchronise. What a request is, a mix kind says
(``vsbench/kinds/<kind>.py``).

The first ``trace_n`` requests of a traced run run under the profiler; the
window then goes on untraced.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, List, Optional

import torch

from vsbench import trace


@dataclasses.dataclass
class Window:
    elapsed_s: float = 0.0
    n_requests: int = 0
    n_queries: int = 0
    # per request: seconds from the call to its synchronised result
    latency_s: List[float] = dataclasses.field(default_factory=list)
    # per search request: (pool rows [b], distances [b, k], ids [b, k], and
    # where the adapter gives them the scan's candidates' scores and ids)
    answers: list = dataclasses.field(default_factory=list)
    # the last index a build window built
    last_index: object = None
    rows_per_build: int = 0
    trace: Optional[trace.Summary] = None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    dev = torch.device(device)
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def loop(call: Callable, n_items: Callable, seconds: float, trace_n: int, device,
         w: Window) -> Window:
    """Run ``call(r)`` for r = 0, 1, ... into ``w``; ``n_items(r)`` counts a
    request's queries or rows. The set-up's objects are frozen out of the
    collector first: a full collection then walks only what the requests made."""
    gc.collect()
    gc.freeze()
    try:
        _loop(call, n_items, seconds, trace_n, device, w)
    finally:
        gc.unfreeze()
    return w


def _loop(call, n_items, seconds, trace_n, device, w):
    prof = trace.profiler(device) if trace_n else None
    traced_queries = 0
    if prof:
        prof.start()
    t0 = time.perf_counter()
    r = 0
    while True:
        with torch.profiler.record_function(trace.SPAN):
            t = time.perf_counter()
            call(r)
            sync(device)
            w.latency_s.append(time.perf_counter() - t)
        w.n_queries += n_items(r)
        r += 1
        if prof and r == trace_n:
            traced_queries = w.n_queries
            prof.stop()
        if time.perf_counter() - t0 >= seconds and (not prof or r >= trace_n):
            break
    w.elapsed_s = time.perf_counter() - t0
    w.n_requests = r
    if prof:
        w.trace = trace.summarize(prof, traced_queries)
