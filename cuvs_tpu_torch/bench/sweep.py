"""In-memory hyper-parameter sweep: grid + constraint pruning + Pareto — port of ``cuvs_tpu.bench.sweep``.

The YAML/registry path (``cuvs_tpu_torch.bench.runner.run_config``) mirrors
the reference's cuvs_bench orchestration; this module is the notebook/HPO
layer on top of the same machinery for datasets that are already in memory
(the reference's analog workflow is Optuna over cuvs_bench configs). Times
are the runner's: wall clock, ended by a device synchronisation on a CUDA run.
"""

from __future__ import annotations

import importlib
import time
from typing import Any, Callable, Dict, List, Optional

from cuvs_tpu_torch.bench import datasets as ds_mod
from cuvs_tpu_torch.bench.runner import _expand_grid as _expand
from cuvs_tpu_torch.bench.runner import _recall, _sync


def run_sweep(
    dataset,
    queries,
    k: int,
    space: Dict[str, Any],
    metric: str = "sqeuclidean",
    reps: int = 3,
    gt_queries: int = 512,
    device=None,
) -> List[Dict[str, Any]]:
    """Sweep build x search grids for one algo over in-memory arrays.

    ``space`` keys: ``algo`` (module name under cuvs_tpu_torch.neighbors),
    ``build`` / ``search`` (param-name -> list of values), optional
    ``constraint`` (callable(build_params, search_params) -> bool, the
    reference's per-combo constraint hook). The arrays go to ``device`` once
    (None: the CUDA card). Returns one dict per surviving combo: {build,
    search, recall, qps, latency_ms, build_s}, sorted by recall descending.
    """
    module = importlib.import_module(f"cuvs_tpu_torch.neighbors.{space['algo']}")
    constraint: Optional[Callable] = space.get("constraint")

    from cuvs_tpu_torch.neighbors import brute_force

    dataset = ds_mod.on_device(dataset, device)
    queries = ds_mod.on_device(queries, dataset.device)
    dev = dataset.device
    nq = min(int(gt_queries), queries.shape[0])
    bf = brute_force.build(dataset, metric=metric)
    _, gti = brute_force.search(bf, queries[:nq], k)
    gti = gti.cpu().numpy()
    del bf

    rows: List[Dict[str, Any]] = []
    for bp in _expand(space.get("build", {})):
        index = None
        for sp in _expand(space.get("search", {})):
            if constraint is not None and not constraint(bp, sp):
                continue
            if index is None:  # build lazily: a fully-pruned bp never builds
                _sync(dev)
                t0 = time.time()
                index = module.build(dataset, metric=metric, **bp)
                _sync(dev)
                build_s = time.time() - t0
            _, i = module.search(index, queries, k, **sp)
            rec = _recall(i[:nq].cpu().numpy(), gti, k)
            t0 = time.time()
            for _ in range(reps):
                module.search(index, queries, k, **sp)
            _sync(dev)
            dt = (time.time() - t0) / reps
            rows.append({
                "build": bp, "search": sp, "recall": round(rec, 4),
                "qps": round(queries.shape[0] / dt, 1),
                "latency_ms": round(dt * 1000, 3),
                "build_s": round(build_s, 3),
            })
    rows.sort(key=lambda r: -r["recall"])
    return rows


def pareto_frontier(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Recall/QPS-dominant subset, recall-ascending (data_export.py's
    frontier semantics)."""
    best: List[Dict[str, Any]] = []
    for r in sorted(rows, key=lambda r: (-r["recall"], -r["qps"])):
        if not best or r["qps"] > best[-1]["qps"]:
            best.append(r)
    return list(reversed(best))
