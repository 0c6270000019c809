"""The readers of the port's stage spans and counters (``vsbench/spans.py``
and the ``program_span`` / ``program_counter`` metrics) on synthetic
records: per-request values, and None where they cannot be read."""

import types

import pytest

from vsbench import spans, spec
from cuvs_tpu_torch.utils import tracing


def _span(i, name, parent=None, request=None, ms=1.0, **counts):
    return tracing.Span(name=name, id=i, parent=parent,
                        request=i if request is None else request, host_start_ns=i,
                        host_end_ns=i + 1, stream_ms=ms, counts=counts)


def _batch(r0, search="ivf_pq::search", refine=True):
    """One b10k request: a fused search (ids r0..r0+4) and, for IVF-PQ, refine."""
    out = [_span(r0, search, ms=100.0, queries=10_000),
           _span(r0 + 1, "ivf::coarse_search", r0, r0, 2.0),
           _span(r0 + 2, "ivf::group", r0, r0, 5.0),
           _span(r0 + 3, "ivf::scan", r0, r0, 78.0),
           _span(r0 + 4, "ivf::merge", r0, r0, 14.0, merge_rows=10_000 * 200 * 2 * 128)]
    return out + ([_span(r0 + 5, "refine::refine", ms=3.0)] if refine else [])


def _run(records, n_requests, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: records)
    return types.SimpleNamespace(trace=types.SimpleNamespace(n_requests=n_requests))


def _read(metric, run):
    return spec.metric(metric).read(run)


def test_per_request_stream_times_and_counts(monkeypatch):
    run = _run(_batch(0) + _batch(10), 2, monkeypatch)
    assert _read("coarse_ms.batch", run) == 2.0
    assert _read("group_ms.batch", run) == 5.0
    assert _read("scan_ms.batch", run) == 78.0
    assert _read("merge_ms.batch", run) == 14.0
    assert _read("refine_ms.batch", run) == _read("refine_ms.q1", run) == 3.0
    assert _read("merge_rows_per_query.batch", run) == 51_200
    assert spec.metric("refine_ms.q1").__file__.endswith("refine_ms.py")


def test_build_stages_in_seconds(monkeypatch):
    names = ["kmeans_balanced::fit", "ivf_pq::assign", "ivf_pq::codebooks", "ivf_pq::encode",
             "ivf_pq::pack"]
    records = [_span(0, "ivf_pq::build", ms=1000.0)]
    records += [_span(i + 1, n, 0, 0, 100.0 * (i + 1)) for i, n in enumerate(names)]
    run = _run(records, 1, monkeypatch)
    got = [_read(f"{m}_s.build", run) for m in ("kmeans", "assign", "codebooks", "encode", "pack")]
    assert got == pytest.approx([0.1, 0.2, 0.3, 0.4, 0.5])


def test_query_major_requests(monkeypatch):
    records = []
    for r in range(4):
        i = 10 * r
        records += [_span(i, "ivf_pq::search", ms=400.0, queries=1),
                    _span(i + 1, "ivf::coarse_search", i, i, 0.5),
                    _span(i + 2, "ivf::query_major", i, i, 390.0),
                    _span(i + 3, "refine::refine", ms=r + 1.0)]
    run = _run(records, 4, monkeypatch)
    assert _read("probe_loop_ms.q1", run) == 390.0
    assert _read("refine_ms.q1", run) == 2.5
    assert _read("scan_ms.batch", run) is None  # no such span


@pytest.mark.parametrize("case", ["missing_span", "more_calls", "fewer_calls", "no_device",
                                  "no_records", "untraced", "older_port"])
def test_none_where_the_records_cannot_be_read(case, monkeypatch):
    records, n = _batch(0, refine=False) + _batch(10, "ivf_flat::search", refine=False), 2
    if case == "missing_span":
        records = [s for s in records if s.name != "ivf::merge"]
    elif case == "more_calls":
        n = 1
    elif case == "fewer_calls":
        n = 3
    elif case == "no_device":
        records[4].stream_ms = None
    elif case == "no_records":
        records = []
    run = _run(records, n, monkeypatch)
    if case == "untraced":
        run.trace = None
    elif case == "older_port":  # the parent's tracing module keeps no records
        monkeypatch.delattr(tracing, "spans")
    assert _read("merge_ms.batch", run) is None
    if case in ("missing_span", "more_calls", "fewer_calls", "no_records", "untraced",
                "older_port"):
        assert _read("merge_rows_per_query.batch", run) is None
    else:  # a counter needs no device
        assert _read("merge_rows_per_query.batch", run) == 51_200
