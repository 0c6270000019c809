"""CLI: python -m cuvs_tpu_torch.bench --dataset synthetic-100k-96 --algo cagra

Port of ``python -m cuvs_tpu.bench``, itself after ``python -m cuvs_bench.run``
(reference python/cuvs_bench): runs a build + search-param sweep, prints one
JSON row per combination, optionally writes CSV with the same
recall/qps/latency columns as data_export.py. Runs on the CUDA card unless
``--device cpu`` (the reference's ``--platform`` was a JAX switch).
"""

import argparse
import json
import sys

from cuvs_tpu_torch.bench import datasets, runner

DEFAULT_GRIDS = {
    "brute_force": {},
    "ivf_flat": {"n_probes": [10, 20, 50, 100]},
    "ivf_pq": {"n_probes": [10, 20, 50], "refine_ratio": [1.0, 2.0]},
    "ivf_sq": {"n_probes": [10, 20, 50, 100]},
    "cagra": {"itopk_size": [32, 64, 128, 256]},
}


def main(argv=None):
    p = argparse.ArgumentParser(prog="cuvs_tpu_torch.bench")
    p.add_argument("--dataset", default="synthetic-100k-96",
                   choices=sorted(datasets.REGISTRY))
    p.add_argument("--algo", action="append", dest="algos",
                   choices=sorted(DEFAULT_GRIDS))
    p.add_argument("--config", default=None,
                   help="YAML sweep config (bundled name or path); replaces --algo")
    p.add_argument("--group", default="base", help="config group to run")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--max-rows", type=int, default=None)
    p.add_argument("--build-params", type=json.loads, default={})
    p.add_argument("--search-grid", type=json.loads, default=None)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--csv", default=None)
    p.add_argument("--pareto", action="store_true")
    p.add_argument("--cache-dir", default=".bench_cache")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; cpu for the host)")
    args = p.parse_args(argv)

    common = dict(k=args.k, max_rows=args.max_rows, reps=args.reps,
                  cache_dir=args.cache_dir, device=args.device)
    if args.config:
        all_rows = runner.run_config(args.config, args.dataset, group=args.group, **common)
    else:
        all_rows = []
        for algo in dict.fromkeys(args.algos or ["cagra"]):
            grid = args.search_grid if args.search_grid is not None else DEFAULT_GRIDS[algo]
            all_rows.extend(runner.run(args.dataset, algo, build_params=args.build_params,
                                       search_grid=grid, **common))
    if args.pareto:
        all_rows = runner.pareto(all_rows)
    for r in all_rows:
        print(json.dumps(r.as_dict()))
    if args.csv:
        runner.write_csv(all_rows, args.csv)
        print(f"# wrote {args.csv}", file=sys.stderr)
    return all_rows


if __name__ == "__main__":
    main()
