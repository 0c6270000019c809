"""``"kind": "build"``: whole index builds on the cell's rows, back to back,
build r with the seed plus r; set-up runs ``warmup`` builds with seeds below
the run's. Judged: the last index the window built, its lists and codes
worked out again by the reference from its own centers, rotation and
codebooks, and the recall of one search of it over the query pool."""

from __future__ import annotations

import time

import torch

from vsbench import check, window
from vsbench.kinds import Cell, Outcome, search


def run(c: Cell) -> Outcome:
    algo, cfg, base, pool = c.algo, c.config, c.base, c.pool
    for i in range(c.mix["warmup"]):
        algo.build(base, cfg, c.seed - 1 - i)
    window.sync(c.device)
    setup_s = time.perf_counter() - c.t0
    w = window.Window(rows_per_build=base.shape[0])

    def call(r):
        w.last_index = None  # the last build's index is freed before the next starts
        w.last_index = algo.build(base, cfg, c.seed + r)

    window.loop(call, lambda r: base.shape[0], c.seconds, c.trace_n, c.device, w)
    peak = window.peak_bytes(c.device)
    index, w.last_index = w.last_index, None
    rows = torch.arange(pool.shape[0], device=pool.device)
    answered = [(rows, *algo.searcher(index, base, cfg)(pool)[:2])]
    st = algo.state(index)
    del index
    if torch.device(c.device).type == "cuda":
        torch.cuda.empty_cache()
    raw = dict(check.build_raw(base, st, c.seed),
               recall_at_10=search.judge(base, pool, answered, cfg, c.limits,
                                         c.seed)["recall_at_10"])
    numbers = check.build_numbers(raw, c.limits)
    return Outcome(setup_s=setup_s, window=w, peak_bytes=peak, numbers=numbers,
                   failed=int(not all(n.passed for n in numbers.values())))
