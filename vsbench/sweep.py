"""The one-time sweep that fixed a configuration's operating point.

    python3 vsbench/sweep.py --config <name> --seeds 11,12 [--reps 5]

For each seed: the configuration's data and index, the reference's exact
neighbours of the 10,000 queries, then for each point of the
configuration's ``sweep`` (every combination of its lists) the recall@10 of
one search of all queries and the QPS of ``reps`` more, timed on the host
clock around work that ends in a device synchronise. One JSON line per point,
also written to ``chiprun_out/sweep_<config>.json``.
"""

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from vsbench import check, data, reference, spec, window

    dev = torch.device("cuda", 0)
    cfg = spec.config(spec.benchmark(ROOT), args.config)
    algo = spec.algo(cfg["algo"])
    keys = sorted(cfg["sweep"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        base, pool = data.make(cfg["data"], seed, dev)
        index = algo.build(base, cfg, seed)
        window.sync(dev)
        build_s = time.perf_counter() - t0
        gt = reference.knn(base, pool, 10, cfg["metric"])[1]
        all_rows = torch.arange(pool.shape[0], device=dev)
        for point in itertools.product(*(cfg["sweep"][k] for k in keys)):
            c = spec._merge(json.loads(json.dumps(cfg)), {"search": dict(zip(keys, point))})
            fn = algo.searcher(index, base, c)
            d, i = fn(pool)
            raw = check.answers(base, pool, gt, [(all_rows, d, i)], c["metric"], 1.0)
            window.sync(dev)
            t = time.perf_counter()
            for _ in range(args.reps):
                fn(pool)
            window.sync(dev)
            qps = args.reps * pool.shape[0] / (time.perf_counter() - t)
            row = {"config": args.config, "seed": seed, **dict(zip(keys, point)),
                   "recall_at_10": raw["recall_at_10"], "qps": qps,
                   "dist_gap": raw["dist_gap"], "setup_and_build_s": build_s,
                   "device": torch.cuda.get_device_name(dev)}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del index, base, pool
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"sweep_{args.config}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
