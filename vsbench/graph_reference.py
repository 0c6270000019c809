"""The plain reference of a graph search: CAGRA's beam search written again
from its stated semantics, and the exact nearest rows a graph's edges are
judged against. Plain PyTorch in float64, TF32 off (``reference.exact``);
imports nothing of the port.

The search (``beam_search``), per query, on the index's own graph:
- entry points: the queries of a chunk that starts at query ``start`` take
  rows of ``randint(0, n, (B, n_seeds))`` drawn by a CPU ``torch.Generator``
  seeded ``((seed & 0xFFFFFFFF) << 32) | start`` (``draw_seeds``), with
  ``n_seeds = max(itopk, num_random_samplings * itopk)``;
- the list: the entry points by distance, an entry point equal to an
  earlier one of its query at +inf, sorted stably, the first ``itopk`` kept;
- a step expands the ``W`` best entries that are unexplored and finite; their
  edges, parent by parent, are the step's children. A child is dropped (+inf)
  if its id is in the list, among the parents expanded so far (this step's
  included), or equal to an earlier child of the step. The list, then the
  children, are sorted stably by distance and cut to ``itopk``;
- the search stops when no entry is unexplored and finite, or after
  ``max_iter`` steps (0: ``itopk // W + 10``, at least 10);
- the answer: the list's first ``k`` entries.
The entry points are those of ``SEARCH_SEED``, ``cagra.search``'s default
seed, which the benchmark's adapter leaves as it is.

Departures from cuVS (``search_single_cta``), as the port makes them:
- cuVS keeps the expanded nodes in a per-query hashmap, and so does this
  reference (a dense [b, n] bitmap); the port keeps a ring of the last 256
  expansion slots. A parent that left the list cannot come back (the list's
  worst entry only falls, and ties go after the list), so what the ring
  forgets changes no answer;
- cuVS draws its entry points with its own generator (``rand_xor_mask``);
  here the port's host draw above;
- cuVS scores in float32 or half and sorts the list with a bitonic network
  (ties in another order); here float64 and stable sorts.
"""

from __future__ import annotations

import torch

from vsbench import reference

_INF = float("inf")
# queries a block of the search: two [block, n] bitmaps (0.5 GB at n = 1M)
_BLOCK = 256
# ``cagra.search``'s default seed: the entry points the benchmark's searches take
SEARCH_SEED = 0


def plan(search: dict) -> tuple:
    """(itopk, max_iter, n_seeds) of a configuration's ``search``."""
    width = search["search_width"]
    itopk = max(search["itopk_size"], search["k"])
    max_iter = search["max_iterations"] or max(10, itopk // width + 10)
    return itopk, max_iter, max(itopk, search["num_random_samplings"] * itopk)


def draw_seeds(n: int, b: int, n_seeds: int, seed: int, start: int) -> torch.Tensor:
    """The entry points [b, n_seeds] int64 (CPU) of the chunk of ``b``
    queries that starts at query ``start``."""
    gen = torch.Generator()
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | int(start))
    return torch.randint(0, n, (b, n_seeds), generator=gen)


def _dist(base, q, ids, ip: bool):
    """Float64 distances of rows ``ids`` [b, m] to their queries [b, d],
    smaller closer (inner product: the negated dot)."""
    x = base[ids].double()
    qd = q.double()[:, None, :]
    return -(x * qd).sum(2) if ip else ((x - qd) ** 2).sum(2)


def _repeats(ids):
    """[b, m] bool: the id occurs earlier in its row."""
    srt, order = torch.sort(ids, dim=1, stable=True)
    rep = torch.zeros_like(ids, dtype=torch.bool)
    rep[:, 1:] = srt[:, 1:] == srt[:, :-1]
    return torch.zeros_like(rep).scatter_(1, order, rep)


def _search(base, q, graph, seeds, k, itopk, width, max_iter, ip):
    b, n = q.shape[0], base.shape[0]
    dev = q.device
    row = torch.arange(b, device=dev)[:, None]
    d = torch.where(_repeats(seeds), _INF, _dist(base, q, seeds, ip))
    order = torch.sort(d, dim=1, stable=True).indices[:, :itopk]
    val, ids = d.gather(1, order), seeds.gather(1, order)
    explored = torch.zeros_like(ids, dtype=torch.bool)
    expanded = torch.zeros((b, n), dtype=torch.bool, device=dev)
    listed = torch.zeros((b, n), dtype=torch.bool, device=dev)
    slot_no = torch.arange(itopk, device=dev)
    steps = 0
    while steps < max_iter:
        open_ = ~explored & torch.isfinite(val)
        if not bool(open_.any()):
            break
        # the first W open slots of each list (itopk: none)
        slots = torch.where(open_, slot_no, itopk).sort(1).values[:, :width]
        valid = slots < itopk
        slots = slots.clamp_max(itopk - 1)
        parents = torch.where(valid, ids.gather(1, slots), -1)
        explored[row.expand_as(slots)[valid], slots[valid]] = True
        expanded[row.expand_as(parents)[valid], parents[valid]] = True
        listed.zero_()
        listed[row.expand_as(ids), ids] = True
        kids = graph[parents.clamp_min(0)]  # [b, W, deg]
        kids = torch.where(valid[:, :, None], kids, -1).reshape(b, -1)
        safe = kids.clamp_min(0)
        drop = (kids < 0) | listed.gather(1, safe) | expanded.gather(1, safe) | _repeats(kids)
        kd = torch.where(drop, _INF, _dist(base, q, safe, ip))
        order = torch.sort(torch.cat([val, kd], 1), dim=1, stable=True).indices[:, :itopk]
        val = torch.cat([val, kd], 1).gather(1, order)
        ids = torch.cat([ids, kids], 1).gather(1, order)
        explored = torch.cat([explored, torch.zeros_like(kids, dtype=torch.bool)], 1).gather(1, order)
        steps += 1
    return (-val[:, :k] if ip else val[:, :k]), ids[:, :k], steps


def beam_search(base, queries, graph, seeds, k: int, itopk: int, width: int, max_iter: int,
                metric: str = "sqeuclidean"):
    """The beam search of ``queries`` [b, d] on ``graph`` [n, deg] from
    ``seeds`` [b, n_seeds] (see the module's docstring): (distances [b, k]
    float64, ids [b, k] int64, steps), ``steps`` the most any query's search
    ran. Distances: squared L2, or the dot for ``inner_product``."""
    reference.exact()
    ip = metric == "inner_product"
    graph, seeds = graph.long(), seeds.long().to(queries.device)
    out_d, out_i, steps = [], [], 0
    for q0 in range(0, queries.shape[0], _BLOCK):
        d, i, s = _search(base, queries[q0:q0 + _BLOCK], graph, seeds[q0:q0 + _BLOCK], k,
                          itopk, width, max_iter, ip)
        out_d.append(d)
        out_i.append(i)
        steps = max(steps, s)
    return torch.cat(out_d), torch.cat(out_i), steps


def nearest_rows(base, rows, k: int, metric: str = "sqeuclidean",
                 block: int = reference.BLOCK // 4):
    """The exact ``k`` nearest other rows of ``base`` to each of ``rows`` [m]
    (the row itself left out), in float64: ids [m, k] int64, closest first."""
    reference.exact()
    n = base.shape[0]
    x = base[rows].double()
    bx = max(k + 1, min(n, block // max(1, x.shape[0])))
    best_v = torch.zeros((x.shape[0], 0), dtype=torch.float64, device=x.device)
    best_i = torch.zeros((x.shape[0], 0), dtype=torch.int64, device=x.device)
    for x0 in range(0, n, bx):
        xb = base[x0:x0 + bx].double()
        dots = x @ xb.T
        d = -dots if metric == "inner_product" else (xb * xb).sum(1)[None] - 2.0 * dots
        own = rows[:, None] == torch.arange(x0, x0 + xb.shape[0], device=x.device)[None]
        d = d.masked_fill(own, _INF)
        v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        best_v, s = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + v.shape[1]),
                               dim=1, largest=False)
        best_i = torch.cat([best_i, i + x0], 1).gather(1, s)
    return best_i
