"""The graph search cell (``kinds/graph_search.py``) on the CPU at a tiny
size: the program passes, and each fault the timed path or the build can
have is refused; the plain beam search imports nothing of the port; the
graph search's readers."""

import ast
import dataclasses

import pytest
import torch

from vsbench import control, control_graph, graph_reference, harness, spec
from vsbench.tests.conftest import ROOT
from vsbench.tests.test_vsbench_faults import altered_answer, half_batch
from vsbench.tests.test_vsbench_spans import _run, _span

CELL = "cagra-sift1m-b10k"
# one chunk of 64 queries; itopk 32 (budget 42 steps, half_steps 21) on a
# 32-degree graph from 64
SHRINK = {"data": {"n_rows": 3000, "n_queries": 64},
          "index": {"intermediate_graph_degree": 64, "graph_degree": 32},
          "search": {"itopk_size": 32, "max_queries": 64}}


def half_answered(algo):
    """Only the first half of each batch answered: the rest has no row."""
    def searcher(index, base, cfg):
        fn = algo.searcher(index, base, cfg)
        return lambda q: tuple(t[:q.shape[0] // 2] for t in fn(q))
    return control.wrap(algo, searcher=searcher)


def shuffled_edges(algo):
    """Each row of the built graph given another row's edges."""
    def build(base, cfg, seed):
        index = algo.build(base, cfg, seed)
        perm = torch.randperm(index.graph.shape[0], generator=torch.Generator().manual_seed(1))
        return dataclasses.replace(index, graph=index.graph[perm.to(index.graph.device)])
    return control.wrap(algo, build=build)


def _run_cell(seed, fault=None):
    return harness.run_cell(CELL, seed, 0.3, False, "cpu", overrides=SHRINK, fault=fault)


def test_program_is_correct():
    r = _run_cell(4242)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["checks"]["beam_miss"]["value"] == 0.0


@pytest.mark.parametrize("fault,number", [
    (half_answered, "missing"), (half_batch, "dist_gap"),
    (altered_answer, "dist_gap"), (control_graph.half_steps, "beam_miss"),
    (control_graph.bfloat16, "dist_gap"), (shuffled_edges, "graph_hit")])
def test_faults_are_not_correct(fault, number):
    r = _run_cell(4242, fault)
    c = r["checks"][number]
    assert r["correct"] is False
    assert (c["value"] > c["limit"]) if c["passes_if"] == "<=" else (c["value"] < c["limit"])


def test_a_window_of_half_answers_fails_every_request():
    r = _run_cell(4243, half_answered)
    assert r["failed"] == r["attempted"] >= 1
    assert r["checks"]["missing"]["value"] == 32 * r["attempted"]


def test_control_readings_fail_their_numbers():
    """At the tiny size the controls read as on the card: each fails the
    number named for it, and the program passes every number."""
    cfg = spec.config(spec.benchmark(), "cagra-sift1m", overrides=SHRINK)
    from vsbench.kinds import graph_search

    got = dict(control_graph.readings(CELL, 77, "cpu", 1, SHRINK))
    limits = spec.limits(cfg, CELL)
    passed = {side: {k: n.passed for k, n in graph_search.numbers(raw, limits).items()}
              for side, raw in got.items()}
    assert all(passed["program"].values()), got["program"]
    assert not passed["half_steps"]["beam_miss"]
    assert not passed["bfloat16"]["dist_gap"]
    assert not passed["reference_tf32"]["dist_gap"]
    assert got["cut_graph"]["graph_hit"] < got["program"]["graph_hit"]


def test_plain_beam_search_finds_the_exact_neighbours_on_an_exact_graph():
    """On the exact k-NN graph of a small set, the plain search from every
    row as an entry point returns the exact nearest rows."""
    g = torch.Generator().manual_seed(3)
    x, q = torch.randn(400, 8, generator=g), torch.randn(20, 8, generator=g)
    graph = graph_reference.nearest_rows(x, torch.arange(400), 16)
    seeds = torch.arange(400).repeat(20, 1)
    d, i, steps = graph_reference.beam_search(x, q, graph, seeds, 5, 400, 1, 10)
    exact = torch.cdist(q.double(), x.double()).pow(2).topk(5, largest=False)
    assert torch.equal(i, exact.indices) and torch.allclose(d, exact.values)
    assert steps == 10


def test_nearest_rows_leave_the_row_out():
    x = torch.randn(300, 8, generator=torch.Generator().manual_seed(4))
    rows = torch.tensor([0, 7, 299])
    d = torch.cdist(x[rows].double(), x.double())
    d[torch.arange(3), rows] = float("inf")
    assert torch.equal(graph_reference.nearest_rows(x, rows, 12, block=1000),
                       d.topk(12, largest=False).indices)


def test_graph_reference_imports_nothing_of_the_port():
    tree = ast.parse((ROOT / "vsbench" / "graph_reference.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"torch", "__future__", "vsbench"}


def _request(i, chunks=1):
    out = [_span(i, "cagra::search", ms=400.0, queries=10_000, beam_steps=138 * chunks)]
    for c in range(chunks):
        out += [_span(i + 1 + 2 * c, "cagra::seeds", i, i, 2.0),
                _span(i + 2 + 2 * c, "cagra::beam", i, i, 390.0)]
    return out


def test_graph_search_readers(monkeypatch):
    run = _run(_request(0) + _request(10, chunks=2), 2, monkeypatch)
    assert spec.metric("beam_ms.batch").read(run) == 585.0
    assert spec.metric("seeds_ms.batch").read(run) == 3.0
    assert spec.metric("beam_steps.batch").read(run) == 207.0


def test_graph_search_readers_leave_out_a_port_without_the_spans(monkeypatch):
    run = _run([_span(0, "cagra::search", ms=400.0), _span(1, "cagra::search", ms=400.0)], 2,
               monkeypatch)
    for name in ("beam_ms.batch", "seeds_ms.batch", "beam_steps.batch"):
        assert spec.metric(name).read(run) is None
