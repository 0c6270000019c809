"""CAGRA's beam search kernel (``ops.cagra_beam``) on the CPU: which chunks
the card would send to it (``fits``), that a CPU search runs the PyTorch loop
and launches nothing, and the loop's own contract that the kernel relies on:
each query stopped on its own gives the batch's lists, and the walk through
the wrapper's plain version answers as the loop. The kernel itself runs only
on the card (``tests/test_torch_gpu.py``)."""

import pytest
import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType
from cuvs_tpu_torch.neighbors import cagra
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.ops import cagra_beam
from cuvs_tpu_torch.utils import tracing

torch.set_num_threads(1)

N, D, NQ, K = 1500, 16, 40, 10


@pytest.fixture(scope="module")
def index():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(N, D, generator=g)
    return cagra.build(x, cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16),
                       device="cpu")


@pytest.fixture(scope="module")
def queries():
    return torch.randn(NQ, D, generator=torch.Generator().manual_seed(6))


def _fits(rows=(64, 32), rows_dtype=torch.float32, graph_degree=16, itopk=64, width=1, ring=0,
          metric=DistanceType.L2Expanded, compute=torch.float32, pack=None, graph=None):
    x = torch.zeros(rows, dtype=rows_dtype)
    g = torch.zeros((rows[0], graph_degree), dtype=torch.int32) if graph is None else graph
    return cagra_beam.fits((x,) if pack is None else pack, g, itopk, width, ring, metric,
                           compute)


# (case, keyword arguments of _fits, taken by the kernel)
FITS = [
    ("f32 rows", {}, True),
    ("bf16 rows", dict(rows_dtype=torch.bfloat16), True),
    ("bf16 compute", dict(compute=torch.bfloat16), True),
    ("inner product", dict(metric=DistanceType.InnerProduct), True),
    ("sqrt L2", dict(metric=DistanceType.L2SqrtExpanded), True),
    ("itopk 512", dict(itopk=512), True),
    ("itopk 513", dict(itopk=513), False),
    ("1024 candidates", dict(width=64), True),
    ("1040 candidates", dict(width=65), False),
    ("ring 1024", dict(ring=1024), True),
    ("ring 1025", dict(ring=1025), False),
    ("no ring", dict(ring=-1), True),
    ("d 1024", dict(rows=(8, 1024)), True),
    ("d 1025", dict(rows=(8, 1025)), False),
    ("f16 rows", dict(rows_dtype=torch.float16), False),
    ("int8 rows", dict(rows_dtype=torch.int8), False),
    ("f16 compute", dict(compute=torch.float16), False),
    ("cosine", dict(metric=DistanceType.CosineExpanded), False),
    ("VPQ codes", dict(pack=(torch.zeros(4, 32), torch.zeros(64, dtype=torch.int32),
                             torch.zeros(64, 8, dtype=torch.uint8), torch.zeros(8, 16, 4))),
     False),
    ("rows not contiguous", dict(pack=(torch.zeros(32, 64).t(),)), False),
    ("graph not contiguous", dict(graph=torch.zeros(16, 64, dtype=torch.int32).t()), False),
    ("int64 graph", dict(graph=torch.zeros(64, 16, dtype=torch.int64)), False),
]


@pytest.mark.parametrize("case,kw,taken", FITS, ids=[c[0] for c in FITS])
def test_fits_takes_raw_rows_within_the_limits(case, kw, taken):
    assert _fits(**kw) is taken


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


@pytest.mark.parametrize("layout", ["raw", "compressed", "packed"])
def test_a_cpu_search_runs_the_loop_and_launches_nothing(index, queries, layout):
    """Raw rows within the limits too: the kernel is for CUDA tensors only."""
    ix = {"raw": lambda: index, "packed": lambda: cagra.pack(index),
          "compressed": lambda: cagra.compress(index, vq_n_centers=16, pq_dim=4)}[layout]()
    before = cagra_beam.LAUNCHES["cagra_beam"]
    _, found = _traced(lambda: cagra.search(ix, queries, K, itopk_size=32, seed=1))
    assert cagra_beam.LAUNCHES["cagra_beam"] == before
    assert not any("beam_kernel_queries" in s.counts for s in found)
    assert found[0].counts["beam_steps"] > 0


def _initial_list(index, queries, itopk, samplings=1, seed=3):
    """A chunk's sorted lists as ``_beam_search`` forms them from the seeds."""
    qf = queries.float()
    qnorm = (qf * qf).sum(1)
    n_seeds = max(itopk, samplings * itopk)
    seeds = cagra._draw_seeds(index.size, queries.shape[0], n_seeds, seed, 0)
    seed_d = cagra._distances_to(index.data_pack, index.dataset_norms, queries, qnorm, seeds,
                                 index.metric, torch.float32)
    earlier = torch.ones((n_seeds, n_seeds), dtype=torch.bool).tril(-1)
    seed_d = torch.where(((seeds[:, :, None] == seeds[:, None, :]) & earlier).any(2),
                         float("inf"), seed_d)
    sv, so = torch.sort(seed_d, dim=1, stable=True)
    return qnorm, sv[:, :itopk], torch.gather(seeds, 1, so)[:, :itopk]


@pytest.mark.parametrize("width,ring", [(1, 0), (1, -1), (2, 16), (2, 0)])
def test_each_query_stopped_on_its_own_gives_the_batch_lists(index, queries, width, ring):
    """The kernel stops each query once it has nothing to expand; the loop
    runs the batch until none has: the lists and counts must agree."""
    itopk = 32
    params = cagra.SearchParams(itopk_size=itopk, search_width=width, visited_size=ring)
    _, max_iter, vis_size = cagra._plan(params, K)
    qnorm, sv, sid = _initial_list(index, queries, itopk)
    args = (index.dataset, index.dataset_norms, index.graph)
    bv, bid, counts = cagra_beam.beam_search(*args, queries, qnorm, sv, sid, width, max_iter,
                                             vis_size, index.metric, torch.float32)
    for i in range(NQ):
        one = slice(i, i + 1)
        v, ident, c = cagra_beam.beam_search(*args, queries[one], qnorm[one], sv[one], sid[one],
                                             width, max_iter, vis_size, index.metric,
                                             torch.float32)
        # a batch of one sums its products in another order on the CPU
        assert torch.equal(ident, bid[one]) and torch.equal(c, counts[one])
        torch.testing.assert_close(v, bv[one], rtol=1e-6, atol=1e-5)
    steps, parents, scored = counts.unbind(1)
    assert int(steps.max()) <= max_iter and int(steps.min()) > 0
    assert bool((parents <= width * steps).all()) and bool((parents >= steps).all())
    if width == 1:
        assert torch.equal(parents, steps)
    assert bool((scored <= parents * index.graph_degree).all()) and int(scored.sum()) > 0


@pytest.mark.parametrize("metric,compute", [("sqeuclidean", torch.float32),
                                            ("inner_product", torch.bfloat16),
                                            ("euclidean", torch.float32)])
def test_the_walk_through_the_wrapper_answers_as_the_loop(index, queries, metric, compute):
    """``_beam_search`` with the wrapper as its walk (on the CPU, the plain
    version) returns the loop's answer and counts the same steps."""
    ix = cagra.from_graph(index.dataset, index.graph, metric=metric)
    itopk, width = 48, 2
    params = cagra.SearchParams(itopk_size=itopk, search_width=width)
    _, max_iter, vis_size = cagra._plan(params, K)
    qnorm, _, _ = _initial_list(ix, queries, itopk)
    seeds = cagra._draw_seeds(ix.size, NQ, itopk, 3, 0)
    seed_d = cagra._distances_to(ix.data_pack, ix.dataset_norms, queries, qnorm, seeds,
                                 ix.metric, compute)
    qids = torch.arange(NQ)

    def score(parents, children):
        return cagra._distances_to(ix.data_pack, ix.dataset_norms, queries, qnorm, children,
                                   ix.metric, compute)

    def walk(state_v, state_id):
        return cagra_beam.beam_search(ix.dataset, ix.dataset_norms, ix.graph, queries, qnorm,
                                      state_v, state_id, width, max_iter, vis_size, ix.metric,
                                      compute)

    def chunk(walk=None):
        with tracing.span("cagra::search"):
            return cagra._beam_search(seed_d, seeds, ix.graph, qids, filt.no_filter(), score, K,
                                      itopk, width, max_iter, vis_size, ix.metric, walk)

    (ld, li), loop_spans = _traced(chunk)
    (wd, wi), walk_spans = _traced(lambda: chunk(walk))
    assert torch.equal(wi, li) and torch.equal(wd, ld)
    names = ["cagra::search", "cagra::beam"]
    assert [s.name for s in walk_spans] == [s.name for s in loop_spans] == names
    steps = loop_spans[0].counts["beam_steps"]
    assert walk_spans[0].counts == loop_spans[0].counts == {"beam_steps": steps}
    assert 0 < steps <= max_iter
