"""A whole run at a tiny size on the CPU: the result line's keys, and a
checkout without a card refused."""

import json

import pytest

from vsbench import harness, run
from vsbench.tests.conftest import CELLS, SHRINK

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, traced):
    r = harness.run_cell(cell, 2**31 + 99, 0.3, traced, "cpu", overrides=SHRINK)
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(r) == want  # ``checks`` last
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(r)
    if not traced:  # the CPU has no device metrics: only the end-to-end ones
        assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    else:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(r["device"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit", "passes_if"}


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "cuvs_tpu_torch_lookalike", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]
