"""Readings of the numbers that decide ``correct`` in a graph search cell
(``kinds/graph_search.py``): of the program, and of the controls put in its
place, at the cell's own size, several seeds in one process.

    python3 vsbench/control_graph.py --workload cagra-sift1m-b10k --seeds 1,2,3 \\
        [--sides program,half_steps,bfloat16,reference_tf32,cut_graph] [--requests N]

Sides: ``program`` (the timed path), ``half_steps`` (the search with half
its step budget: ``beam_miss``'s control), ``cut_graph`` (the graph built
from a k-NN graph of refine ratio 1 and 5 probes: ``graph_hit``'s),
``bfloat16`` (the search scoring in bf16: ``dist_gap``'s) and
``reference_tf32`` (the reference's exact k-NN with TF32 products in the
program's place). Each answers the first N requests of the cell's mix (the
default: one), judged as a run judges its window. One JSON line per seed and
side, also written to ``chiprun_out/control_<workload>.json``. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vsbench import control, graph_reference, spec  # noqa: E402

SIDES = ("program", "half_steps", "bfloat16", "reference_tf32", "cut_graph")


def _with(cfg: dict, part: str, **over) -> dict:
    return dict(cfg, **{part: dict(cfg[part], **over)})


def half_steps(algo):
    """An adapter whose searches stop after half the auto step budget."""
    def searcher(index, base, cfg):
        budget = graph_reference.plan(cfg["search"])[1]
        return algo.searcher(index, base, _with(cfg, "search", max_iterations=budget // 2))
    return control.wrap(algo, searcher=searcher)


def cut_graph(algo):
    """An adapter whose graphs come from a coarser k-NN graph: its IVF-PQ
    candidates from 5 probes, not re-ranked beyond the k kept (refine x 1)."""
    def build(base, cfg, seed):
        return algo.build(base, _with(cfg, "index", refine_ratio=1, build_n_probes=5), seed)
    return control.wrap(algo, build=build)


def bfloat16(algo):
    """An adapter whose searches score in bf16."""
    def searcher(index, base, cfg):
        return algo.searcher(index, base, _with(cfg, "search", compute_dtype="bfloat16"))
    return control.wrap(algo, searcher=searcher)


WRAP = {"half_steps": half_steps, "cut_graph": cut_graph, "bfloat16": bfloat16}


def readings(name: str, seed: int, device, n_requests: int = 1, overrides=None,
             sides=SIDES) -> list:
    """[(side, raw numbers)] of each side for one seed."""
    import torch

    from vsbench import check, data
    from vsbench.kinds import graph_search, search

    bm = spec.benchmark(ROOT)
    cell = spec.cell(bm, name)
    cfg = spec.config(bm, cell["config"], ROOT, overrides)
    limits = spec.limits(cfg, name, ROOT)
    mix = spec.mix(cell["traffic"])
    algo = spec.algo(cfg["algo"])
    base, pool = data.make(cfg["data"], seed, device)
    reqs, batches = search.requests(mix, pool, seed)
    asked = [reqs[r % len(reqs)] for r in range(n_requests)]
    index = algo.build(base, cfg, seed) if set(sides) - {"cut_graph"} else None
    out = []
    for side in sides:
        a = WRAP[side](algo) if side in WRAP else algo
        built = a.build(base, cfg, seed) if side == "cut_graph" else index
        if side == "reference_tf32":
            answered = check.control_answers(base, pool, asked, cfg["search"]["k"], cfg["metric"])
        else:
            fn = a.searcher(built, base, cfg)
            answered = [search.answer(fn, batches, reqs, r) for r in range(n_requests)]
            del fn
        out.append((side, graph_search.judge(base, pool, answered, built.graph, cfg, mix,
                                             limits, seed)))
        del built
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="cagra-sift1m-b10k")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default=",".join(SIDES))
    ap.add_argument("--requests", type=int, default=1)
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
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"control_{args.workload}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
