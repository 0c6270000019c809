"""``"kind": "search"``: a closed loop of one client over requests of queries
from the cell's query pool (the configuration's ``n_queries``). With
``"order": "permuted"`` request r is the whole pool in the r-th of
``n_orders`` orders drawn from the seed (the same work every request, never
the same batch twice running); with ``"sequential"`` the requests walk
through the pool in order, ``batch`` queries each. Set-up builds the index
and runs ``warmup`` requests. Judged: every answer of the window, and where
the adapter hands out the scan's candidates, those of a sample of requests
drawn from the seed (``CAND_SAMPLE`` queries)."""

from __future__ import annotations

import time

import torch

from vsbench import check, data, reference, window
from vsbench.kinds import Cell, Outcome

# queries whose candidates are judged
CAND_SAMPLE = 10_000


def requests(mix: dict, pool: torch.Tensor, seed: int):
    """The distinct requests of a search mix: (pool rows of each, queries of
    each). Sequential requests are views of the pool: no launch each."""
    n_pool, device = pool.shape[0], pool.device
    if mix["order"] == "permuted":
        g = data.generator(seed + 1, device)
        rows = [torch.randperm(n_pool, generator=g, device=device) for _ in range(mix["n_orders"])]
        return rows, [pool[r] for r in rows]
    if mix["order"] == "sequential":
        b, every = mix["batch"], torch.arange(n_pool, device=device)
        starts = range(0, n_pool - b + 1, b)
        return [every[r0:r0 + b] for r0 in starts], [pool[r0:r0 + b] for r0 in starts]
    raise ValueError(f"unknown order {mix['order']!r}")


def answer(fn, batches: list, reqs: list, r: int) -> tuple:
    """Request r's (pool rows, *what ``fn`` returns)."""
    i = r % len(batches)
    return (reqs[i], *fn(batches[i]))


def run(c: Cell) -> Outcome:
    algo, cfg = c.algo, c.config
    index = algo.build(c.base, cfg, c.seed)
    fn = algo.searcher(index, c.base, cfg)
    reqs, batches = requests(c.mix, c.pool, c.seed)
    for r in range(c.mix["warmup"]):
        fn(batches[r % len(batches)])
    window.sync(c.device)
    setup_s = time.perf_counter() - c.t0
    w = window.Window()
    window.loop(lambda r: w.answers.append(answer(fn, batches, reqs, r)),
                lambda r: len(reqs[r % len(reqs)]), c.seconds, c.trace_n, c.device, w)
    peak = window.peak_bytes(c.device)
    work = roofline_work(algo, index, c.base, c.pool, reqs, c.trace_n, cfg) if c.trace_n else {}
    quant = algo.quantizer(index) if hasattr(algo, "quantizer") else None
    del fn, index
    if torch.device(c.device).type == "cuda":
        torch.cuda.empty_cache()
    raw = judge(c.base, c.pool, w.answers, cfg, c.limits, c.seed, quant)
    return Outcome(setup_s=setup_s, window=w, peak_bytes=peak,
                   numbers=check.search_numbers(raw, c.limits),
                   failed=raw["failed_requests"], work=work)


def judge(base, pool, answered: list, cfg: dict, limits: dict, seed: int, quant=None) -> dict:
    """The raw numbers of search answers: every answer against the
    reference's exact neighbours, and with ``quant`` (the index's centers,
    rotation and codebooks) the candidates of a seeded sample of requests
    against the reference's PQ search."""
    rows = torch.unique(torch.cat([a[0] for a in answered]))
    gt = torch.zeros((pool.shape[0], 10), dtype=torch.int64, device=pool.device)
    gt[rows] = reference.knn(base, pool[rows], 10, cfg["metric"])[1]
    raw = check.answers(base, pool, gt, answered, cfg["metric"], limits["dist_gap"])
    if quant is not None and len(answered[0]) == 5:
        g = torch.Generator().manual_seed(int(seed) % (1 << 63))
        picked, n = [], 0
        for j in torch.randperm(len(answered), generator=g).tolist():
            if n >= CAND_SAMPLE:
                break
            picked.append(answered[j])
            n += len(answered[j][0])
        raw.update(check.candidates(base, pool, torch.cat([a[0] for a in picked]),
                                    torch.cat([a[3] for a in picked]),
                                    torch.cat([a[4] for a in picked]), quant,
                                    cfg["search"]["n_probes"], cfg["metric"]))
    return raw


def roofline_work(algo, index, base, pool, reqs, n_traced, cfg) -> dict:
    """The least seconds of the traced requests' scans, counted from the problem."""
    if not hasattr(algo, "work"):
        return {}
    sizes = torch.bincount(reference.nearest_center(base, index.centers),
                           minlength=index.centers.shape[0])
    total: dict = {}
    for r in range(n_traced):
        for fam, s in algo.work(index, base, sizes, pool[reqs[r % len(reqs)]], cfg).items():
            total[fam] = total.get(fam, 0.0) + s
    return total
