"""Benchmark runner: build/search sweeps with recall/QPS/latency rows — port of ``cuvs_tpu.bench.runner``.

Reference: the cuvs_bench harness (cpp/bench/ann/src/common/benchmark.hpp
metrics; python orchestration python/cuvs_bench/cuvs_bench/run/). Output rows
and CSV columns are the reference's (data_export.py's columns), byte for byte.

Measurement, as the reference's:
  * ``build_s``: wall clock of one build, ended by a device synchronisation.
    On a CUDA run the kernels' library (nvcc) is built before the first
    timed build, so no row's ``build_s`` holds compile time.
  * ``recall``: of the first ``gt_queries`` queries' ids from one untimed
    search, against exact ground truth (``datasets.groundtruth``).
  * ``qps`` / ``latency_ms``: wall clock of ``reps`` searches of the whole
    query set after that untimed one, read after ``torch.cuda.synchronize``
    on a CUDA run; host-side work of each search included. This is not
    ``bench/measure.py``'s CUDA-event loop over rolled batches.

Data placement: the dataset's base rows and queries go to the run's device
once per run (float64 as float32, as the reference's ``jnp.asarray`` makes it;
the synthetic stand-in is float64 under numpy 2), so ``refine`` re-ranks
against rows already on the device. ``device=None`` is the CUDA card;
``device="cpu"`` runs on the host.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from cuvs_tpu_torch.bench import datasets as ds_mod
from cuvs_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Row:
    algo: str
    dataset: str
    build_s: float
    params: Dict[str, Any]
    recall: float
    qps: float
    latency_ms: float

    def as_dict(self):
        d = dataclasses.asdict(self)
        d["params"] = json.dumps(self.params, default=str)
        return d


def _recall(found, gt, k):
    return float(np.mean([
        len(set(a[:k].tolist()) & set(b[:k].tolist())) / k for a, b in zip(found, gt)
    ]))


# algo name -> (build_fn(build_params) -> index,
#               search_fn(index, queries, k, search_params) -> (d, i)),
# closed over the dataset (its rows on the run's device) so refine_ratio can
# re-rank against ds.base.
def _algo_table(ds):
    from cuvs_tpu_torch.neighbors import (
        brute_force, cagra, ivf_flat, ivf_pq, ivf_rabitq, ivf_sq, refine,
    )

    def refined(module):
        def search(ix, q, k, p):
            p = dict(p)
            ratio = float(p.pop("refine_ratio", 1.0))
            if ratio > 1.0:
                _, cand = module.search(ix, q, int(k * ratio), **p)
                return refine.refine(ds.base, q, cand, k, metric=ds.metric)
            return module.search(ix, q, k, **p)
        return search

    def hnsw_build(p):
        from cuvs_tpu_torch.bench.competitors import HnswCpu

        return HnswCpu(metric=ds.metric, **p).build(ds.base.cpu().numpy())

    return {
        "brute_force": (
            lambda p: brute_force.build(ds.base, metric=ds.metric),
            lambda ix, q, k, p: brute_force.search(
                ix, q, k, **{k_: v for k_, v in p.items() if v is not None}),
        ),
        "ivf_flat": (
            lambda p: ivf_flat.build(ds.base, metric=ds.metric, **p),
            lambda ix, q, k, p: ivf_flat.search(ix, q, k, **p),
        ),
        "ivf_pq": (
            lambda p: ivf_pq.build(ds.base, metric=ds.metric, **p),
            refined(ivf_pq),
        ),
        "ivf_sq": (
            lambda p: ivf_sq.build(ds.base, metric=ds.metric, **p),
            lambda ix, q, k, p: ivf_sq.search(ix, q, k, **p),
        ),
        "ivf_rabitq": (
            lambda p: ivf_rabitq.build(ds.base, metric=ds.metric, **p),
            refined(ivf_rabitq),
        ),
        "cagra": (
            lambda p: cagra.build(ds.base, metric=ds.metric, **p),
            lambda ix, q, k, p: cagra.search(ix, q, k, **p),
        ),
        # competitor row (reference: cpp/bench/ann/src/hnswlib/): CPU
        # single-thread HNSW, an independent implementation
        # (native/hnsw_baseline.cpp)
        "hnsw_cpu": (
            hnsw_build,
            lambda ix, q, k, p: ix.search(q.cpu().numpy(), k, **p),
        ),
    }


def _expand_grid(grid: Dict[str, Sequence]) -> List[Dict]:
    if not grid:
        return [{}]
    keys = sorted(grid)
    return [dict(zip(keys, vals)) for vals in itertools.product(*(grid[k] for k in keys))]


def _placed(dataset: str, max_rows: Optional[int], device) -> ds_mod.Dataset:
    """The dataset with its base rows and queries on the run's device."""
    ds = ds_mod.load(dataset, max_rows=max_rows)
    dev = resolve_device(device)
    return dataclasses.replace(ds, base=ds_mod.on_device(ds.base, dev),
                               queries=ds_mod.on_device(ds.queries, dev))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ids(out) -> np.ndarray:
    i = out[1]
    return i.cpu().numpy() if isinstance(i, torch.Tensor) else np.asarray(i)


def _timed_build(build_fn, params: Dict, dev: torch.device):
    """(index, wall seconds of the build). On a CUDA run the kernels are
    built first, outside the timed build."""
    if dev.type == "cuda":
        from cuvs_tpu_torch.ops import _lib

        _lib.lib()
    _sync(dev)
    t0 = time.time()
    index = build_fn(params)
    _sync(dev)
    return index, time.time() - t0


def _search_rows(algo, ds, build_s, index, search_fn, combos, gti, k, gt_queries, reps, dev,
                 build: Optional[Dict] = None) -> List[Row]:
    """One Row per search combo: recall of one untimed search, then the wall
    clock of ``reps`` searches. Row params: the combo, or {"build": build,
    "search": combo} for a config sweep."""
    rows = []
    q = ds.queries
    for sp in combos:
        out = search_fn(index, q, k, sp)
        _sync(dev)
        rec = _recall(_ids(out)[:gt_queries], gti, k)
        t0 = time.time()
        for _ in range(reps):
            search_fn(index, q, k, sp)
        _sync(dev)
        dt = (time.time() - t0) / reps
        rows.append(Row(
            algo=algo, dataset=ds.name, build_s=round(build_s, 3),
            params=sp if build is None else {"build": build, "search": sp},
            recall=round(rec, 4),
            qps=round(q.shape[0] / dt, 1), latency_ms=round(dt * 1000, 3),
        ))
    return rows


def run(
    dataset: str,
    algo: str,
    build_params: Optional[Dict] = None,
    search_grid: Optional[Dict[str, Sequence]] = None,
    k: int = 10,
    max_rows: Optional[int] = None,
    gt_queries: int = 1024,
    reps: int = 3,
    cache_dir: Optional[str] = None,
    device=None,
) -> List[Row]:
    """Build once, sweep search params, return one Row per combination."""
    ds = _placed(dataset, max_rows, device)
    dev = ds.base.device
    table = _algo_table(ds)
    if algo not in table:
        raise ValueError(f"unknown algo {algo!r}; known: {sorted(table)}")
    build_fn, search_fn = table[algo]

    _, gti = ds_mod.groundtruth(ds, k=k, gt_queries=gt_queries, cache_dir=cache_dir)
    index, build_s = _timed_build(build_fn, build_params or {}, dev)
    return _search_rows(algo, ds, build_s, index, search_fn, _expand_grid(search_grid or {}),
                        gti, k, gt_queries, reps, dev)


def load_config(name_or_path: str) -> Dict:
    """Load a YAML sweep config (reference config/algos/*.yaml layout:
    name, optional constraints.{build,search} dotted names, groups of
    build/search grids). Bare names resolve to the port's bundled configs/;
    a path may name the reference's files too (``constraints.resolve`` maps
    their hooks to the port's)."""
    import os

    import yaml

    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(os.path.dirname(__file__), "configs", f"{name_or_path}.yaml")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if "name" not in cfg or "groups" not in cfg:
        raise ValueError(f"config {name_or_path!r} needs 'name' and 'groups'")
    return cfg


def run_config(
    config: str,
    dataset: str,
    group: str = "base",
    k: int = 10,
    max_rows: Optional[int] = None,
    gt_queries: int = 1024,
    reps: int = 3,
    cache_dir: Optional[str] = None,
    device=None,
) -> List[Row]:
    """Run a full YAML sweep: every valid build combo x search combo
    (constraint hooks drop invalid pairs, mirroring cuvs_bench's
    config/algos/constraints)."""
    from cuvs_tpu_torch.bench import constraints as cons

    cfg = load_config(config)
    algo = cfg["name"]
    grp = cfg["groups"][group]
    hooks = cfg.get("constraints", {})
    build_ok = cons.resolve(hooks["build"]) if "build" in hooks else None
    search_ok = cons.resolve(hooks["search"]) if "search" in hooks else None

    ds = _placed(dataset, max_rows, device)
    dev = ds.base.device
    dims = ds.base.shape[1]
    batch = ds.queries.shape[0]
    build_fn, search_fn = _algo_table(ds)[algo]
    gti = None
    rows: List[Row] = []
    for bp in _expand_grid(grp.get("build") or {}):
        if build_ok is not None and not build_ok(bp, dims):
            continue
        combos = [
            sp for sp in _expand_grid(grp.get("search") or {})
            if search_ok is None or search_ok(sp, bp, k, batch)
        ]
        if not combos:
            continue
        if gti is None:
            _, gti = ds_mod.groundtruth(ds, k=k, gt_queries=gt_queries, cache_dir=cache_dir)
        # build once, then time each valid search combo
        index, build_s = _timed_build(build_fn, bp, dev)
        rows.extend(_search_rows(algo, ds, build_s, index, search_fn, combos, gti, k,
                                 gt_queries, reps, dev, build=bp))
        del index  # freed before the next build
    return rows


def pareto(rows: List[Row]) -> List[Row]:
    """Recall/QPS Pareto frontier (cuvs_bench plot's frontier logic)."""
    best: List[Row] = []
    for r in sorted(rows, key=lambda r: (-r.recall, -r.qps)):
        if not best or r.qps > best[-1].qps:
            best.append(r)
    return best


def write_csv(rows: List[Row], path: str) -> None:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["algo", "dataset", "build_s", "params", "recall", "qps", "latency_ms"]
        )
        w.writeheader()
        for r in rows:
            w.writerow(r.as_dict())
