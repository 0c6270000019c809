"""Finds a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
the configuration file it names, ``vsbench/mixes/<traffic>.json``, the
mix's ``vsbench/kinds/<kind>.py``, ``vsbench/metrics/<metric>.py``,
``vsbench/algos/<algo>.py`` and, where a cell has limits of its own,
``vsbench/limits/<cell>.json``."""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "vsbench"
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _one(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if not found:
        raise ValueError(f"unknown {what} {name!r}; known: {[e['name'] for e in entries]}")
    return found[0]


def cell(bm: dict, name: str) -> dict:
    return _one(bm["workloads"], _checked(name), "workload")


def _merge(into: dict, over: dict) -> dict:
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(into.get(key), dict):
            _merge(into[key], value)
        else:
            into[key] = value
    return into


def config(bm: dict, name: str, root: Path = ROOT, overrides: dict | None = None) -> dict:
    """The configuration file's contents, with ``overrides`` merged in (the
    CPU tests shrink a configuration so; a run never does)."""
    entry = _one(bm["configs"], _checked(name), "config")
    cfg = json.loads((Path(root) / entry["file"]).read_text())
    return _merge(copy.deepcopy(cfg), overrides or {})


def mix(name: str) -> dict:
    path = HERE / "mixes" / f"{_checked(name)}.json"
    if not path.exists():
        raise ValueError(f"unknown traffic {name!r}: no {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def limits(cfg: dict, cell_name: str, root: Path = ROOT) -> dict:
    """The limits of the numbers a cell compares: the configuration's
    ``check``, with those of ``vsbench/limits/<cell>.json`` over them, where a
    cell's path reads another precision than its configuration's others."""
    path = Path(root) / "vsbench" / "limits" / f"{_checked(cell_name)}.json"
    own = json.loads(path.read_text()) if path.exists() else {}
    return dict(cfg["check"], **own)


def kind(name: str):
    """The driver of a mix kind: ``run(kinds.Cell) -> kinds.Outcome``."""
    if not (HERE / "kinds" / f"{_checked(name)}.py").exists():
        raise ValueError(f"unknown mix kind {name!r}")
    return importlib.import_module(f"vsbench.kinds.{name}")


def metric(name: str):
    """The reader module of one metric: ``read(run) -> float | None``. A
    metric without a file of its own takes the reader of its name up to the
    last dot: ``idle_share.q1`` reads as ``idle_share``."""
    stem = _checked(name)
    while not (HERE / "metrics" / f"{stem}.py").exists():
        if "." not in stem:
            raise ValueError(f"unknown metric {name!r}: no reader in vsbench/metrics/")
        stem = stem.rsplit(".", 1)[0]
    path = HERE / "metrics" / f"{stem}.py"
    mod_spec = importlib.util.spec_from_file_location(f"vsbench.metrics.{stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def algo(name: str):
    if not (HERE / "algos" / f"{_checked(name)}.py").exists():
        raise ValueError(f"unknown algo {name!r}")
    return importlib.import_module(f"vsbench.algos.{name}")


def metrics_of(bm: dict, cell_name: str, traced: bool) -> list:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer ones:
    those that list the cell, and those without a list whose end-to-end
    metric (``moves``) the cell reports."""
    e2e = [m for m in bm["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bm["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in names else [])]
