"""Recall-QPS plotting + data export — port of ``cuvs_tpu.bench.plot``.

Reference: python/cuvs_bench/cuvs_bench/run/data_export.py (JSON -> CSV
with recall/qps/latency columns) and cuvs_bench.plot (Pareto frontier
throughput/latency charts). Rows come straight from
cuvs_tpu_torch.bench.runner; the files are the reference's byte for byte.
matplotlib is imported only by ``plot_pareto``.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

from cuvs_tpu_torch.bench.runner import Row, pareto, write_csv  # re-export  # noqa: F401


def export_csv(rows: Sequence[Row], path: str) -> None:
    """data_export parity: one CSV with recall/qps/latency columns."""
    write_csv(list(rows), path)


def plot_pareto(
    rows: Sequence[Row],
    path: str,
    mode: str = "throughput",
    title: Optional[str] = None,
) -> None:
    """Render recall-vs-QPS (or latency) Pareto frontiers, one line per
    algo (cuvs_bench.plot analog). ``mode``: "throughput" (y = QPS, log)
    or "latency" (y = ms, log, lower is better)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    algos = sorted({r.algo for r in rows})
    fig, ax = plt.subplots(figsize=(7, 5))
    for algo in algos:
        sub = [r for r in rows if r.algo == algo]
        front = pareto(sub) if mode == "throughput" else sorted(
            sub, key=lambda r: r.recall
        )
        xs = [r.recall for r in front]
        ys = [r.qps if mode == "throughput" else r.latency_ms for r in front]
        order = sorted(range(len(xs)), key=lambda i: xs[i])
        ax.plot([xs[i] for i in order], [ys[i] for i in order],
                marker="o", label=algo)
        # non-frontier points as faint markers
        if mode == "throughput":
            rest = [r for r in sub if r not in front]
            ax.scatter([r.recall for r in rest], [r.qps for r in rest],
                       alpha=0.25, s=12)
    ax.set_xlabel("recall@k")
    ax.set_ylabel("QPS" if mode == "throughput" else "latency (ms)")
    ax.set_yscale("log")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    elif rows:
        ax.set_title(rows[0].dataset)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def export_json(rows: Sequence[Row], path: str) -> None:
    """google-benchmark-style JSON (benchmark.hpp counters analog)."""
    out = {
        "benchmarks": [
            {
                "name": f"{r.algo}/{json.dumps(r.params, default=str)}",
                "dataset": r.dataset,
                "Recall": r.recall,
                "items_per_second": r.qps,
                "Latency": r.latency_ms / 1e3,
                "build_seconds": r.build_s,
            }
            for r in rows
        ]
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
