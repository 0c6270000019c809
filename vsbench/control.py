"""Readings of the numbers that decide ``correct``: of the program, and of the
controls and faults put in its place, at a cell's own size, several seeds in
one process.

    python3 vsbench/control.py --workload <name> --seeds 1,2,3 \\
        [--sides program,reference_tf32] [--requests N]

Sides of a search cell: ``program`` (the timed path), ``reference_tf32``
(the reference's k-NN with TF32 products in the program's place),
``lut_<dtype>`` (the program with its lookup table in ``<dtype>``: its own
lower-precision path), ``tf32`` (the program with TF32 matmuls),
``half_probes`` (the scan's candidates from half of the lists). Each answers
the first N requests of the cell's mix (the default: as many queries as one
pool), judged as a run judges its window. Sides of a build cell:
``program`` (the build, and one search of its index), ``reference_tf32``
(the lists and codes worked out again from the same centers and codebooks
with TF32 products), ``untrained`` (the build with its k-means and codebook
EM iterations skipped: centers and codebooks left where they started). One
JSON line per seed and side, also written to
``chiprun_out/control_<workload>.json``. The benchmark's own runs never run
this.
"""

import argparse
import contextlib
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _tf32():
    import torch

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


@contextlib.contextmanager
def _no_training():
    """The port's k-means and codebook EM iterations return their starting
    centers and codebooks."""
    from cuvs_tpu_torch.cluster import kmeans_balanced
    from cuvs_tpu_torch.neighbors import ivf_pq

    saved = (kmeans_balanced._em_iters, kmeans_balanced._balancing_iters, ivf_pq._em)
    kmeans_balanced._em_iters = lambda x, centers, *a: centers
    kmeans_balanced._balancing_iters = lambda gen, x, centers, *a: centers
    ivf_pq._em = lambda xs, c, *a, **kw: c
    try:
        yield
    finally:
        kmeans_balanced._em_iters, kmeans_balanced._balancing_iters, ivf_pq._em = saved


def wrap(algo, **over):
    """A copy of an algo adapter with some of its functions replaced."""
    parts = {k: getattr(algo, k) for k in dir(algo) if not k.startswith("__")}
    return types.SimpleNamespace(**dict(parts, **over))


def untrained(algo):
    """An algo adapter whose builds skip the training iterations."""
    def build(*args, **kw):
        with _no_training():
            return algo.build(*args, **kw)
    return wrap(algo, build=build)


def half_probes(algo):
    """An algo adapter whose scan takes its candidates from the nearer half
    of the probed lists only, as a pool merge that drops part of the pool
    would hand them on (IVF-PQ: refine re-ranks them)."""
    def searcher(index, base, cfg):
        s = cfg["search"]
        return algo.searcher(index, base, dict(cfg, search=dict(s, n_probes=s["n_probes"] // 2)))
    return wrap(algo, searcher=searcher)


def readings(name: str, seed: int, device, n_requests: int = 0, overrides=None,
             sides=("program", "reference_tf32")) -> list:
    """[(side, raw numbers)] of each side for one seed."""
    import torch

    from vsbench import check, data, spec
    from vsbench.kinds import search

    bm = spec.benchmark(ROOT)
    cell = spec.cell(bm, name)
    cfg = spec.config(bm, cell["config"], ROOT, overrides)
    limits = spec.limits(cfg, name, ROOT)
    mix = spec.mix(cell["traffic"])
    algo = spec.algo(cfg["algo"])
    base, pool = data.make(cfg["data"], seed, device)
    out = []
    if mix["kind"] == "build":
        rows = torch.arange(pool.shape[0], device=pool.device)
        index = None
        for side in sides:
            if side != "reference_tf32" or index is None:
                index = (untrained(algo) if side == "untrained" else algo).build(base, cfg, seed)
            st = algo.state(index)
            if side == "reference_tf32":
                out.append((side, check.build_raw(base, check.control_state(base, st), seed)))
                continue
            answered = [(rows, *algo.searcher(index, base, cfg)(pool)[:2])]
            recall = search.judge(base, pool, answered, cfg, limits, seed)["recall_at_10"]
            out.append((side, dict(check.build_raw(base, st, seed), recall_at_10=recall)))
        return out
    index = algo.build(base, cfg, seed)
    quant = algo.quantizer(index) if hasattr(algo, "quantizer") else None
    reqs, batches = search.requests(mix, pool, seed)
    n = n_requests or max(1, pool.shape[0] // len(reqs[0]))
    for side in sides:
        if side == "reference_tf32":
            answered = check.control_answers(base, pool, [reqs[r % len(reqs)] for r in range(n)],
                                             cfg["search"]["k"], cfg["metric"])
        else:
            c = cfg
            if side.startswith("lut_"):
                c = spec._merge(json.loads(json.dumps(cfg)), {"search": {"lut_dtype": side[4:]}})
            fn = (half_probes(algo) if side == "half_probes" else algo).searcher(index, base, c)
            with _tf32() if side == "tf32" else contextlib.nullcontext():
                answered = [search.answer(fn, batches, reqs, r) for r in range(n)]
            del fn
        out.append((side, search.judge(base, pool, answered, cfg, limits, seed, quant)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,reference_tf32")
    ap.add_argument("--requests", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    dev = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for side, raw in readings(args.workload, seed, dev, args.requests,
                                  sides=args.sides.split(",")):
            row = {"workload": args.workload, "seed": seed, "side": side, **raw,
                   "device": torch.cuda.get_device_name(dev)}
            print(json.dumps(row), flush=True)
            rows.append(row)
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"control_{args.workload}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
