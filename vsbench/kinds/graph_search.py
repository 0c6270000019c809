"""``"kind": "graph_search"``: the closed loop of ``search`` (the whole query
pool a request, in ``n_orders`` orders from the seed) over a graph index
(its search graph: ``index.graph``), whose searches start from the entry
points of ``graph_reference.SEARCH_SEED``. Its own ``run``, since
``search.run`` judges with ``search.judge``, which takes only requests whose
every query has an answer row. Judged:
- every answer of the window (``check.answers``: ``dist_gap``,
  ``recall_at_10`` over every query asked, ``malformed``), and ``missing``:
  queries of a request left without an answer row (limit 0);
- ``beam_miss``: on ``beam_sample`` queries of one request drawn from the
  seed, the share of the plain beam search's ids (``graph_reference``: the
  same graph, the same entry points, float64) that the answer lacks;
- ``graph_hit``: on ``graph_sample`` rows drawn from the seed, the share of
  each row's graph edges among its exact ``intermediate_graph_degree``
  nearest rows (float64): the build judged by itself."""

from __future__ import annotations

import time

import torch

from vsbench import check, graph_reference, reference, window
from vsbench.kinds import Cell, Outcome, search


def run(c: Cell) -> Outcome:
    algo, cfg = c.algo, c.config
    index = algo.build(c.base, cfg, c.seed)
    fn = algo.searcher(index, c.base, cfg)
    reqs, batches = search.requests(c.mix, c.pool, c.seed)
    for r in range(c.mix["warmup"]):
        fn(batches[r % len(batches)])
    window.sync(c.device)
    setup_s = time.perf_counter() - c.t0
    w = window.Window()
    window.loop(lambda r: w.answers.append(search.answer(fn, batches, reqs, r)),
                lambda r: len(reqs[r % len(reqs)]), c.seconds, c.trace_n, c.device, w)
    peak = window.peak_bytes(c.device)
    graph = index.graph
    del fn, index
    if torch.device(c.device).type == "cuda":
        torch.cuda.empty_cache()
    raw = judge(c.base, c.pool, w.answers, graph, cfg, c.mix, c.limits, c.seed)
    return Outcome(setup_s=setup_s, window=w, peak_bytes=peak, numbers=numbers(raw, c.limits),
                   failed=raw["failed_requests"])


def judge(base, pool, answered: list, graph, cfg: dict, mix: dict, limits: dict,
          seed: int) -> dict:
    """The raw numbers of the answers [(pool rows, distances, ids), ...] of a
    graph index; ``seed`` draws the samples judged."""
    metric, k = cfg["metric"], cfg["search"]["k"]
    rows = torch.unique(torch.cat([a[0] for a in answered]))
    gt = torch.zeros((pool.shape[0], 10), dtype=torch.int64, device=pool.device)
    gt[rows] = reference.knn(base, pool[rows], 10, metric)[1]
    raw = {"dist_gap": 0.0, "malformed": 0, "missing": 0, "failed_requests": 0}
    hits, asked = 0, 0
    for a in answered:
        m = min(len(a[0]), a[2].shape[0])
        asked += len(a[0])
        raw["missing"] += len(a[0]) - m
        bad = m < len(a[0])
        if m:
            got = check.answers(base, pool, gt, [(a[0][:m], a[1][:m], a[2][:m])], metric,
                                limits["dist_gap"])
            raw["dist_gap"] = max(raw["dist_gap"], got["dist_gap"])
            raw["malformed"] += got["malformed"]
            hits += round(got["recall_at_10"] * m * min(k, 10))
            bad |= got["failed_requests"] > 0
        raw["failed_requests"] += int(bad)
    raw["recall_at_10"] = hits / (asked * min(k, 10))
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    j = int(torch.randint(len(answered), (1,), generator=g))
    raw["beam_miss"] = beam_miss(base, pool, answered[j], graph, cfg, mix["beam_sample"], g)
    raw["graph_hit"] = graph_hit(base, graph, cfg, mix["graph_sample"], g)
    return raw


def beam_miss(base, pool, answer: tuple, graph, cfg: dict, sample: int, g) -> float:
    """The share of the plain beam search's ids that the answer lacks, on
    ``sample`` of its queries drawn by ``g``; the plain search starts from the
    entry points the program drew for those queries' places in the request."""
    s, n = cfg["search"], base.shape[0]
    rows, ids = answer[0], answer[2]
    m = min(len(rows), ids.shape[0])
    pos = torch.randperm(m, generator=g)[:sample].sort().values
    if not len(pos):  # nothing answered
        return 1.0
    itopk, max_iter, n_seeds = graph_reference.plan(s)
    chunk = s["max_queries"]
    seeds = torch.empty((len(pos), n_seeds), dtype=torch.int64)
    for start in range(0, len(rows), chunk):
        here = (pos >= start) & (pos < start + chunk)
        if bool(here.any()):
            drawn = graph_reference.draw_seeds(n, min(chunk, len(rows) - start), n_seeds,
                                               graph_reference.SEARCH_SEED, start)
            seeds[here] = drawn[pos[here] - start]
    pos = pos.to(rows.device)
    kk = min(s["k"], 10)
    ref = graph_reference.beam_search(base, pool[rows[pos]], graph, seeds, kk, itopk,
                                      s["search_width"], max_iter, cfg["metric"])[1]
    got = ids[pos][:, :kk].long()
    found = (ref[:, :, None] == got[:, None, :]).any(2).sum()
    return 1.0 - int(found) / (len(pos) * kk)


def graph_hit(base, graph, cfg: dict, sample: int, g) -> float:
    """The share of the graph's edges of ``sample`` rows drawn by ``g`` that
    lie among each row's exact ``intermediate_graph_degree`` nearest rows."""
    n = base.shape[0]
    rows = torch.randperm(n, generator=g)[:sample].to(base.device)
    near = graph_reference.nearest_rows(base, rows, min(cfg["index"]["intermediate_graph_degree"],
                                                        n - 1), cfg["metric"])
    edges = graph[rows].long()
    return float((edges[:, :, None] == near[:, None, :]).any(2).double().mean())


def numbers(raw: dict, limits: dict) -> dict:
    out = check.search_numbers(raw, limits)
    out["missing"] = check.Number(raw["missing"], 0, "max")
    out["beam_miss"] = check.Number(raw["beam_miss"], limits["beam_miss"], "max")
    out["graph_hit"] = check.Number(raw["graph_hit"], limits["graph_hit"], "min")
    return out
