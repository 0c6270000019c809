"""The port's stage spans and counters (``cuvs_tpu_torch.utils.tracing``):
recording follows the profiler exactly, the records nest, count and sit on
the profiler's clock, and the IVF entry points yield their stages."""

import dataclasses

import pytest
import torch

from cuvs_tpu_torch.neighbors import ivf_flat, ivf_pq, refine
from cuvs_tpu_torch.utils import tracing

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _capture():
    """A capture as the benchmark starts one: ``profile(...).start()``."""
    prof = torch.profiler.profile(activities=CPU, acc_events=True)
    prof.start()
    return prof


def _nested():
    with tracing.span("outer"):
        tracing.count("seen", 2)
        with tracing.span("inner"):
            tracing.count("rows", 3)
            tracing.count("rows", 4)
        with tracing.span("inner2"):
            pass
        tracing.count("seen", 1)
    with tracing.span("second"):
        pass


def test_nothing_records_and_no_range_opens_without_a_capture(monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

    def no_event(*a, **k):
        raise AssertionError("a CUDA event while no capture runs")

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not torch.autograd.profiler._is_profiler_enabled
    _nested()
    assert tracing.traced("port::entry")(lambda a: a + 1)(1) == 2
    tracing.count("rows", torch.ones(()))  # no-op while off, even for a tensor
    assert tracing.span("a") is tracing.span("b")  # one shared no-op
    assert opened == [] and tracing.spans() == []


def test_records_nest_share_a_request_and_count_on_the_innermost_span():
    prof = _capture()
    try:
        _nested()
        tracing.traced("port::entry")(_nested)()
    finally:
        prof.stop()
    spans = tracing.spans()
    assert [s.name for s in spans] == ["outer", "inner", "inner2", "second", "port::entry",
                                       "outer", "inner", "inner2", "second"]
    outer, inner, inner2, second, entry, *under = spans
    assert outer.parent is None and outer.request == outer.id
    assert inner.parent == inner2.parent == outer.id
    assert inner.request == inner2.request == outer.id
    assert second.parent is None and second.request == second.id
    assert outer.counts == {"seen": 3} and inner.counts == {"rows": 7} and inner2.counts == {}
    assert entry.parent is None
    assert [s.parent for s in under] == [entry.id, under[0].id, under[0].id, entry.id]
    assert all(s.request == entry.id for s in under)
    assert len({s.id for s in spans}) == len(spans)
    assert all(s.host_start_ns <= s.host_end_ns and s.stream_ms is None for s in spans)
    assert [f.name for f in dataclasses.fields(tracing.Span)] == [
        "name", "id", "parent", "request", "host_start_ns", "host_end_ns", "stream_ms", "counts"]
    # recording stopped with the capture
    _nested()
    assert len(tracing.spans()) == len(spans)
    tracing.clear()
    assert tracing.spans() == []


def test_count_takes_host_integers_only():
    prof = _capture()
    try:
        with tracing.span("s"):
            with pytest.raises(TypeError):
                tracing.count("rows", torch.tensor(3))
            tracing.count("rows", 5)
    finally:
        prof.stop()
    assert tracing.spans()[0].counts == {"rows": 5}


def test_records_lie_on_the_profiler_clock():
    """Each record's host start and end within 50 us of its
    ``record_function`` event in the same capture. The clock is the same;
    what separates them is the few instructions between the range's entry
    and the clock read, so a scheduler preemption there (the tests run beside
    other workers) is retried, at most twice."""
    for attempt in range(3):
        tracing.clear()
        prof = _capture()
        try:
            for i in range(3):  # the first ranges of a process start slowly
                with tracing.span(f"warm{i}"):
                    pass
            for i in range(6):
                with tracing.span(f"clock{i}"):
                    with tracing.span(f"clock{i}.inner"):
                        torch.ones(64).sum()
        finally:
            prof.stop()
        events = {e.name(): e for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("clock")}
        gaps = []
        for s in tracing.spans():
            if s.name.startswith("clock"):
                e = events[s.name]
                gaps += [abs(s.host_start_ns - e.start_ns()),
                         abs(s.host_end_ns - (e.start_ns() + e.duration_ns()))]
        assert len(gaps) == 24
        if max(gaps) <= 50_000:
            return
    pytest.fail(f"records {max(gaps) / 1e3:.1f} us from their profiler events")


def test_stream_time_is_an_event_pair_resolved_when_read(monkeypatch):
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t = None
            made.append(self)

        def record(self):
            self.t = len(made)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return float(end.t - self.t)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    prof = _capture()
    try:
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
    finally:
        prof.stop()
    outer, inner = tracing.spans()
    # events in order: outer start (1), inner start (2), inner end (3), outer end (4)
    assert len(made) == 4 and outer.stream_ms == 3.0 and inner.stream_ms == 1.0
    assert [s.stream_ms for s in tracing.spans()] == [3.0, 1.0]  # read once, kept


def test_start_profiler_trace_starts_the_records_anew(tmp_path):
    prof = _capture()
    with tracing.span("before"):
        pass
    prof.stop()
    tracing.start_profiler_trace(str(tmp_path))
    try:
        with tracing.span("during"):
            pass
    finally:
        tracing.stop_profiler_trace()
    assert [s.name for s in tracing.spans()] == ["during"]


# --- the IVF entry points' stages (CPU: the plain versions of the kernels)

N, D, NQ, LISTS, PROBES = 3000, 32, 40, 16, 4
SEARCH_STAGES = ["ivf::coarse_search", "ivf::group", "ivf::scan", "ivf::merge"]
QUERY_MAJOR = ["ivf::coarse_search", "ivf::query_major"]
BUILD_STAGES = ["kmeans_balanced::fit", "ivf_pq::assign", "ivf_pq::codebooks",
                "ivf_pq::encode", "ivf_pq::pack"]


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(5)
    return torch.randn(N, D, generator=g), torch.randn(NQ, D, generator=g)


@pytest.fixture(scope="module")
def pq_index(data):
    return ivf_pq.build(data[0], ivf_pq.IndexParams(n_lists=LISTS, pq_dim=8), device="cpu")


@pytest.fixture(scope="module")
def flat_index(data):
    return ivf_flat.build(data[0], ivf_flat.IndexParams(n_lists=LISTS), device="cpu")


def _traced(fn):
    prof = _capture()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, tracing.spans()


def _one_call(spans, entry):
    """The entry span and the names of the spans under it, checked to be
    its direct children of one request, in order."""
    assert spans[0].name == entry and spans[0].parent is None
    for s in spans[1:]:
        assert s.parent == spans[0].id and s.request == spans[0].id, s
    return spans[0], [s.name for s in spans[1:]]


def _pq_merge_rows(index, algo, k):
    if algo == "fused":  # cap = 2 at k <= 64: 2 x 128 lane bins a pair
        return NQ * PROBES * 2 * 128
    eff = max(1, index.n_rows // index.n_lists // 128)  # cluster-major: bin_cap rounds
    bin_cap = min(k, 32, max(2, -(-2 * k // eff)))
    return NQ * PROBES * bin_cap * (index.window // 128)


@pytest.mark.parametrize("algo", ["query_major", "cluster_major", "fused"])
def test_ivf_pq_search_yields_its_stages(data, pq_index, algo):
    k = 20
    (d, i), spans = _traced(lambda: ivf_pq.search(
        pq_index, data[1], k, ivf_pq.SearchParams(n_probes=PROBES, scan_algo=algo)))
    entry, stages = _one_call(spans, "ivf_pq::search")
    assert entry.counts == {"queries": NQ}
    assert stages == (QUERY_MAJOR if algo == "query_major" else SEARCH_STAGES)
    if algo != "query_major":
        assert spans[-1].counts == {"merge_rows": _pq_merge_rows(pq_index, algo, k)}
    # the spans change nothing of the answer
    d0, i0 = ivf_pq.search(pq_index, data[1], k,
                           ivf_pq.SearchParams(n_probes=PROBES, scan_algo=algo))
    assert torch.equal(i, i0) and torch.equal(d, d0)


@pytest.mark.parametrize("algo", ["query_major", "cluster_major", "fused"])
def test_ivf_flat_search_yields_its_stages(data, flat_index, algo):
    k = 10
    _, spans = _traced(lambda: ivf_flat.search(
        flat_index, data[1], k, ivf_flat.SearchParams(n_probes=PROBES, scan_algo=algo)))
    entry, stages = _one_call(spans, "ivf_flat::search")
    assert entry.counts == {"queries": NQ}
    assert stages == (QUERY_MAJOR if algo == "query_major" else SEARCH_STAGES)
    if algo == "fused":
        assert spans[-1].counts == {"merge_rows": NQ * PROBES * 2 * 128}
    elif algo == "cluster_major":  # the pair tiles keep k rows a pair
        assert spans[-1].counts == {"merge_rows": NQ * PROBES * k}


@pytest.mark.parametrize("codebook_gen", ["per_subspace", "per_cluster"])
def test_ivf_pq_build_yields_its_stages(data, codebook_gen):
    params = ivf_pq.IndexParams(n_lists=LISTS, pq_dim=8, pq_bits=5, codebook_gen=codebook_gen)
    index, spans = _traced(lambda: ivf_pq.build(data[0], params, device="cpu"))
    _, stages = _one_call(spans, "ivf_pq::build")
    assert stages == BUILD_STAGES
    again = ivf_pq.build(data[0], params, device="cpu")
    assert torch.equal(index.sorted_codes, again.sorted_codes)


def test_ivf_flat_build_and_refine_are_spans(data, pq_index):
    _, spans = _traced(lambda: ivf_flat.build(data[0], ivf_flat.IndexParams(n_lists=LISTS),
                                              device="cpu"))
    assert _one_call(spans, "ivf_flat::build")[1] == ["kmeans_balanced::fit"]
    tracing.clear()
    cand = ivf_pq.search(pq_index, data[1], 20, ivf_pq.SearchParams(n_probes=PROBES))[1]
    _, spans = _traced(lambda: refine.refine(data[0], data[1], cand, 10, device="cpu"))
    assert [(s.name, s.parent) for s in spans] == [("refine::refine", None)]
