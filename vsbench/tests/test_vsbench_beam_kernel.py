"""The reader of the beam kernel's share (``beam_kernel_share.batch``) on
synthetic records: 1.0 where every chunk ran the kernel, the share of the
queries where some did, None where the program counts no kernel queries."""

from vsbench import spec
from vsbench.tests.test_vsbench_spans import _run, _span


def _request(i, chunks=1, walked=(True,)):
    out = [_span(i, "cagra::search", ms=40.0, queries=10_000, beam_steps=138 * chunks)]
    for c in range(chunks):
        counts = {"beam_kernel_queries": 10_000 // chunks} if walked[c] else {}
        out += [_span(i + 1 + 2 * c, "cagra::seeds", i, i, 2.0),
                _span(i + 2 + 2 * c, "cagra::beam", i, i, 30.0, **counts)]
    return out


def test_every_chunk_through_the_kernel_reads_one(monkeypatch):
    run = _run(_request(0) + _request(10, chunks=2, walked=(True, True)), 2, monkeypatch)
    assert spec.metric("beam_kernel_share.batch").read(run) == 1.0


def test_a_chunk_on_the_loop_lowers_the_share(monkeypatch):
    run = _run(_request(0) + _request(10, chunks=2, walked=(True, False)), 2, monkeypatch)
    assert spec.metric("beam_kernel_share.batch").read(run) == 0.75


def test_a_program_without_the_kernel_leaves_it_out(monkeypatch):
    run = _run(_request(0, walked=(False,)) + _request(10, walked=(False,)), 2, monkeypatch)
    assert spec.metric("beam_kernel_share.batch").read(run) is None
