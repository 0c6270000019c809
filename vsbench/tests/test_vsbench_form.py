"""BENCHMARK.json keeps the form its checker holds it to: keys, names, units, limits."""

import json
import re

import pytest

from vsbench import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size():
    raw = (spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    bm = json.loads(raw)
    assert set(bm) == {"command", "paths", "run_seconds", *KEYS}


@pytest.mark.parametrize("section", sorted(KEYS))
def test_every_entry_has_exactly_its_keys(section):
    must, may = KEYS[section]
    for entry in spec.benchmark()[section]:
        assert must <= set(entry) <= must | may, (section, entry.get("name"))
        assert NAME.fullmatch(entry["name"])


def test_names_are_unique_and_within_their_counts():
    bm = spec.benchmark()
    metrics = bm["end_to_end"] + bm["per_layer"]
    for group, top in ((bm["configs"], 24), (bm["workloads"], 24), (metrics, None)):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert top is None or 1 <= len(names) <= top
    assert 1 <= len(bm["end_to_end"]) <= 16 and 1 <= len(bm["per_layer"]) <= 128


def test_command_and_paths():
    bm = spec.benchmark()
    assert 1 <= len(bm["paths"]) <= 16
    for p in bm["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir()
    assert 1 <= len(bm["command"]) <= 32 and all(_line(w) for w in bm["command"])
    for word in bm["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if (spec.ROOT / word).is_file():
            assert any(word.startswith(p + "/") for p in bm["paths"])


def test_configs():
    bm = spec.benchmark()
    used = {w["config"] for w in bm["workloads"]}
    files = [c["file"] for c in bm["configs"]]
    assert len(files) == len(set(files))
    for c in bm["configs"]:
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bm["paths"])
        assert (spec.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])


def test_workloads():
    bm = spec.benchmark()
    configs = {c["name"] for c in bm["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bm["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bm["workloads"]:
        assert w["config"] in configs and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    four = sum(w["chips"] == 4 for w in bm["workloads"])
    assert four <= max(1, len(bm["workloads"]) // 4)


def test_metrics():
    bm = spec.benchmark()
    cells = {w["name"] for w in bm["workloads"]}
    e2e = {m["name"]: m for m in bm["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells and m.get("workloads", [1])
    for m in bm["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert isinstance(m["bound"], (int, float)) and 0.01 <= m["bound"] <= 0.25
    for m in bm["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_run_seconds_fits_the_full_check_of_24_cells():
    s = spec.benchmark()["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
