"""CAGRA's search held against a plain beam search written again here from
its stated semantics (float64, on the index's own graph and the same entry
points), and the search's and build's stage spans and counters."""

import pytest
import torch

from cuvs_tpu_torch.neighbors import cagra
from cuvs_tpu_torch.utils import tracing

N, D, NQ, K = 3000, 32, 120, 10
# f32 distances (|q|^2 + |x|^2 - 2 q.x, products of 32 terms) against float64,
# over |q|^2 + |x|^2: a few float32 ulps
DIST_TOL = 1e-6


def draw_seeds(n: int, b: int, n_seeds: int, seed: int, start: int) -> torch.Tensor:
    """The entry points [b, n_seeds] of the chunk of ``b`` queries at query
    ``start``: ``randint`` from a CPU generator seeded by (seed, start)."""
    gen = torch.Generator()
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | int(start))
    return torch.randint(0, n, (b, n_seeds), generator=gen)


def _first_repeats(ids):
    """[b, m] bool: the id occurs earlier in its row."""
    same = ids[:, :, None] == ids[:, None, :]
    return (same & torch.ones_like(same[0]).tril(-1)).any(2)


def plain_beam_search(x, queries, graph, seeds, k: int, itopk: int, width: int, max_iter: int):
    """Squared-L2 beam search in float64: the list is the entry points sorted
    stably (a repeated one at +inf), cut to ``itopk``; a step expands the
    ``width`` best unexplored finite entries and drops each child already in
    the list, expanded before, or earlier in the step; the list and the
    children are sorted stably and cut; it stops when nothing is open or
    after ``max_iter`` steps. (distances [b, k], ids [b, k], steps)."""
    x, q = x.double(), queries.double()
    b, graph, seeds = q.shape[0], graph.long(), seeds.long()

    def dist(ids):
        return ((x[ids] - q[:, None, :]) ** 2).sum(2)

    row = torch.arange(b)[:, None]
    d = torch.where(_first_repeats(seeds), float("inf"), dist(seeds))
    order = torch.sort(d, dim=1, stable=True).indices[:, :itopk]
    val, ids = d.gather(1, order), seeds.gather(1, order)
    explored = torch.zeros_like(ids, dtype=torch.bool)
    expanded = torch.zeros((b, x.shape[0]), dtype=torch.bool)
    steps = 0
    while steps < max_iter:
        open_ = ~explored & torch.isfinite(val)
        if not bool(open_.any()):
            break
        slots = torch.where(open_, torch.arange(itopk), itopk).sort(1).values[:, :width]
        valid = slots < itopk
        slots = slots.clamp_max(itopk - 1)
        parents = torch.where(valid, ids.gather(1, slots), -1)
        explored[row.expand_as(slots)[valid], slots[valid]] = True
        expanded[row.expand_as(parents)[valid], parents[valid]] = True
        kids = torch.where(valid[:, :, None], graph[parents.clamp_min(0)], -1).reshape(b, -1)
        safe = kids.clamp_min(0)
        drop = (kids < 0) | (kids[:, :, None] == ids[:, None, :]).any(2)
        drop |= expanded.gather(1, safe) | _first_repeats(kids)
        all_v = torch.cat([val, torch.where(drop, float("inf"), dist(safe))], 1)
        order = torch.sort(all_v, dim=1, stable=True).indices[:, :itopk]
        val, ids = all_v.gather(1, order), torch.cat([ids, kids], 1).gather(1, order)
        explored = torch.cat([explored, torch.zeros_like(kids, dtype=torch.bool)], 1).gather(
            1, order)
        steps += 1
    return val[:, :k], ids[:, :k], steps


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(21)
    return torch.randn(N, D, generator=g), torch.randn(NQ, D, generator=g)


@pytest.fixture(scope="module")
def index(data):
    return cagra.build(data[0], cagra.IndexParams(intermediate_graph_degree=64,
                                                  graph_degree=32), device="cpu")


def _plain(index, x, queries, params: cagra.SearchParams, seed: int, start: int = 0):
    """The plain search of ``queries``, a chunk that starts at query ``start``,
    from that chunk's own entry points."""
    itopk = max(params.itopk_size, K)
    max_iter = params.max_iterations or max(10, itopk // params.search_width + 10)
    n_seeds = max(itopk, params.num_random_samplings * itopk)
    seeds = draw_seeds(x.shape[0], queries.shape[0], n_seeds, seed, start)
    return plain_beam_search(x, queries, index.graph, seeds, K, itopk, params.search_width,
                             max_iter)


def _close(d, ref_d, x, queries, ids):
    scale = (queries.double() ** 2).sum(1, keepdim=True) + (x[ids.long()].double() ** 2).sum(2)
    return float(((d.double() - ref_d).abs() / scale).max()) <= DIST_TOL


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("itopk", [32, 64, 256])
def test_search_returns_the_plain_beam_search(data, index, itopk, width):
    x, q = data
    params = cagra.SearchParams(itopk_size=itopk, search_width=width)
    d, i = cagra.search(index, q, K, params, seed=7)
    ref_d, ref_i, _ = _plain(index, x, q, params, 7)
    assert torch.equal(i.long(), ref_i)
    assert _close(d, ref_d, x, q, i)


@pytest.mark.parametrize("itopk,ring", [(32, 16), (64, 32)])
def test_expanded_parents_drop_out_of_the_ring_as_in_the_port(data, index, itopk, ring):
    """A visited ring shorter than the steps (as the port's 256 slots at
    itopk 256, whose budget is 266 steps) forgets the first parents, and
    the port still answers as the plain search, which forgets none."""
    x, q = data
    params = cagra.SearchParams(itopk_size=itopk, visited_size=ring)
    d, i = cagra.search(index, q, K, params, seed=11)
    ref_d, ref_i, steps = _plain(index, x, q, params, 11)
    assert steps > ring
    assert torch.equal(i.long(), ref_i)
    assert _close(d, ref_d, x, q, i)


@pytest.mark.parametrize("seed,start", [(0, 0), (7, 80), (2**40 + 3, 1024), (2**63 - 1, 5)])
def test_the_two_seed_recipes_draw_the_same_ids(seed, start):
    assert torch.equal(cagra._draw_seeds(N, 50, 64, seed, start).long(),
                       draw_seeds(N, 50, 64, seed, start))


@pytest.mark.parametrize("chunk", [NQ, 50])
def test_each_chunk_is_the_plain_search_from_its_own_draw(data, index, chunk):
    """One chunk of every query (the benchmark's max_queries) and chunks of
    50: each chunk answers as the plain search fed that chunk's entry points."""
    x, q = data
    params = cagra.SearchParams(itopk_size=32, query_chunk=chunk)
    d, i = cagra.search(index, q, K, params, seed=3)
    for s in range(0, NQ, chunk):
        ref_d, ref_i, _ = _plain(index, x, q[s:s + chunk], params, 3, s)
        assert torch.equal(i[s:s + chunk].long(), ref_i)
        assert _close(d[s:s + chunk], ref_d, x, q[s:s + chunk], i[s:s + chunk])


def _traced(fn):
    tracing.clear()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  acc_events=True)
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    found = tracing.spans()
    tracing.clear()
    return out, found


@pytest.mark.parametrize("chunk", [NQ, 50])
def test_search_spans_and_counters(data, index, chunk):
    x, q = data
    params = cagra.SearchParams(itopk_size=32, query_chunk=chunk)
    (d, i), found = _traced(lambda: cagra.search(index, q, K, params, seed=3))
    entry = found[0]
    assert entry.name == "cagra::search" and entry.parent is None
    starts = range(0, NQ, chunk)
    assert [(s.name, s.parent) for s in found[1:]] == \
        [(n, entry.id) for _ in starts for n in ("cagra::seeds", "cagra::beam")]
    steps = sum(_plain(index, x, q[s:s + chunk], params, 3, s)[2] for s in starts)
    assert entry.counts == {"queries": NQ, "beam_steps": steps}
    assert 10 <= steps <= len(starts) * cagra._plan(params, K)[1]
    # the spans change nothing of the answer
    d0, i0 = cagra.search(index, q, K, params, seed=3)
    assert torch.equal(i, i0) and torch.equal(d, d0)


def test_build_spans(data, index):
    x, _ = data
    params = cagra.IndexParams(intermediate_graph_degree=64, graph_degree=32)
    built, found = _traced(lambda: cagra.build(x, params, device="cpu"))
    entry = found[0]
    assert entry.name == "cagra::build" and entry.parent is None
    assert [s.name for s in found if s.parent == entry.id] == \
        ["cagra::knn_graph", "cagra::optimize"]
    assert torch.equal(built.graph, index.graph)


def test_nothing_records_without_a_capture(data, index):
    tracing.clear()
    cagra.search(index, data[1], K, cagra.SearchParams(itopk_size=32), seed=3)
    assert tracing.spans() == []
