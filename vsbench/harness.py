"""One run of one cell: make the data, build, warm up, run the window, judge
what the window produced, and read the cell's metrics."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from vsbench import data, kinds, spec, trace, window


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``vsbench/metrics/<name>.py``)."""

    cell: dict
    config: dict
    mix: dict
    setup_s: float
    window: window.Window
    numbers: dict
    # scan kernel family -> least seconds of the traced requests' work
    work: dict

    @property
    def trace(self) -> Optional[trace.Summary]:
        return self.window.trace


def _device_info(device, peak: int, w: window.Window) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": peak}
    if w.trace is not None:
        info.update(busy_s=w.trace.busy_s, window_s=w.trace.window_s)
    return info


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             root: Path = spec.ROOT, overrides: Optional[dict] = None,
             fault: Optional[Callable] = None) -> dict:
    """The result line of one run (``fault`` wraps the algo's entry points:
    the CPU tests break the timed path with it)."""
    t0 = time.perf_counter()
    bm = spec.benchmark(root)
    cell = spec.cell(bm, name)
    cfg = spec.config(bm, cell["config"], root, overrides)
    mix = spec.mix(cell["traffic"])
    wanted = spec.metrics_of(bm, name, traced)
    readers = {m["name"]: spec.metric(m["name"]) for m in wanted}
    algo = spec.algo(cfg["algo"])
    if fault is not None:
        algo = fault(algo)
    trace_n = mix["trace_requests"] if traced else 0
    if traced:  # the profiler's first start initialises CUPTI: not in the window
        with trace.profiler(device):
            torch.ones(1, device=device).add_(1)
    base, pool = data.make(cfg["data"], seed, device)
    out = spec.kind(mix["kind"]).run(kinds.Cell(
        name=name, config=cfg, mix=mix, limits=spec.limits(cfg, name, root), algo=algo,
        base=base, pool=pool, seed=seed, seconds=seconds, trace_n=trace_n, device=device,
        t0=t0))
    w, numbers = out.window, out.numbers
    run = Run(cell=cell, config=cfg, mix=mix, setup_s=out.setup_s, window=w, numbers=numbers,
              work=out.work)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(n.passed for n in numbers.values()), "attempted": w.n_requests,
              "failed": out.failed, "metrics": metrics,
              "device": _device_info(device, out.peak_bytes, w)}
    if traced:
        result["breakdown"] = w.trace.breakdown
    result["checks"] = {k: {"value": n.value, "limit": n.limit,
                            "passes_if": "<=" if n.kind == "max" else ">="}
                        for k, n in numbers.items()}
    return result

