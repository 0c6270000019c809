"""Search throughput on a CUDA device — port of ``cuvs_tpu.bench.measure``.

QPS over the search loop, warm-up excluded (benchmark.hpp:337-413), timed with
CUDA events around all reps. Every rep searches a distinct query batch (the
batch rolled by the rep number: the same work, other inputs), so no layer can
serve a rep from a cached result. The reference's relay fold is a TPU-relay
workaround and is not ported.
"""

from __future__ import annotations

import torch


def _elapsed_s(fn, batches) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches:
        fn(b)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def timed_qps(fn, queries: torch.Tensor, reps: int = 5, min_time_s: float = 0.0,
              max_reps: int = 64) -> float:
    """Queries per second of ``fn(queries) -> (dists, ids)`` on ``queries``'
    CUDA device. With ``min_time_s``, reps scale up (to ``max_reps``) until
    the timed window is at least that long."""
    if not queries.is_cuda:
        raise RuntimeError(f"timed_qps measures a CUDA device; queries are on {queries.device}")
    fn(queries)  # warm-up
    torch.cuda.synchronize(queries.device)
    if min_time_s > 0:
        per_rep = max(_elapsed_s(fn, [torch.roll(queries, 1, 0)]), 1e-6)
        reps = int(max(reps, min(max_reps, -(-min_time_s // per_rep))))
    batches = [torch.roll(queries, r + 1, 0) for r in range(reps)]
    torch.cuda.synchronize(queries.device)
    return queries.shape[0] * reps / _elapsed_s(fn, batches)
