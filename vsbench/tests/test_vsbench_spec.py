"""The loader finds every part that BENCHMARK.json names, by name."""

import pytest

from vsbench import spec


def test_every_named_part_is_found():
    bm = spec.benchmark()
    for c in bm["configs"]:
        cfg = spec.config(bm, c["name"])
        assert cfg["name"] == c["name"]
        assert spec.algo(cfg["algo"]).build
        assert set(cfg["reduced"]) == set(c["reduced"])
    for w in bm["workloads"]:
        assert spec.cell(bm, w["name"])["config"] in {c["name"] for c in bm["configs"]}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert callable(spec.kind(spec.mix(w["traffic"])["kind"]).run)
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert callable(spec.metric(m["name"]).read)


@pytest.mark.parametrize("find", [
    lambda bm: spec.cell(bm, "no-such-cell"),
    lambda bm: spec.config(bm, "no-such-config"),
    lambda bm: spec.mix("no-such-mix"),
    lambda bm: spec.metric("no_such_metric"),
    lambda bm: spec.algo("no_such_algo"),
    lambda bm: spec.mix("../configs/ivfpq-sift1m"),
    lambda bm: spec.kind("no_such_kind"),
    lambda bm: spec.metric("no_such_metric.q1"),
])
def test_unknown_names_are_refused(find):
    with pytest.raises(ValueError):
        find(spec.benchmark())


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bm = spec.benchmark()
    for w in bm["workloads"]:
        e2e = {m["name"] for m in spec.metrics_of(bm, w["name"], False)}
        layer = spec.metrics_of(bm, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer and all(m["moves"] in e2e for m in layer)


def test_a_metric_without_a_file_takes_the_reader_of_its_stem():
    assert spec.metric("idle_share.anything").__file__.endswith("idle_share.py")
    assert spec.metric("recall_at_10.q1").__file__.endswith("recall_at_10.py")


def test_a_cell_limits_file_overrides_its_configuration_check():
    bm = spec.benchmark()
    cfg = spec.config(bm, "ivfpq-sift1m")
    own = spec.limits(cfg, "ivfpq-sift1m-q1")
    assert own["dist_gap"] == cfg["check"]["dist_gap"]
    assert own["pq_gap"] < cfg["check"]["pq_gap"]
    assert spec.limits(cfg, "ivfpq-sift1m-b10k") == cfg["check"]
