"""The port's bench harness against the JAX package's, on the CPU.

Exact equality where the two do the same arithmetic: the bundled configs (the
reference's, hook names mapped), the constraint hooks (over a ``hypothesis``
grid), ``_expand_grid``, the Pareto fronts, the CSV and JSON files (byte for
byte), ground truth (ids but at ties, distances rtol 1e-5) and its ``.npz``
cache read across packages, ``download``'s error, and the CPU HNSW competitor
(the same C++ source, single-threaded: equal ids and distances).

Own builds: ``run``, ``run_config`` and ``run_sweep`` on ``device="cpu"``
give the reference's rows and params; brute-force recall is equal; an
approximate row's recall is within 0.05 of the reference's (``RECALL_TOL``),
because the two packages draw other k-means and CAGRA seeds from one seed.
The searches of those tests run a 1000-query cut of the dataset's 10,000
queries in both packages (``few_queries``): the recall is of the first
``gt_queries`` either way.
"""

import csv
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cuvs_tpu.bench import competitors as jax_competitors
from cuvs_tpu.bench import constraints as jax_constraints
from cuvs_tpu.bench import datasets as jax_datasets
from cuvs_tpu.bench import gt as jax_gt
from cuvs_tpu.bench import plot as jax_plot
from cuvs_tpu.bench import runner as jax_runner
from cuvs_tpu.bench import sweep as jax_sweep
from cuvs_tpu.cluster import kmeans_balanced as jax_kmb
from cuvs_tpu.neighbors import brute_force as jax_brute_force
from cuvs_tpu_torch.bench import __main__ as cli
from cuvs_tpu_torch.bench import competitors, constraints, datasets, gt, plot, runner, sweep
from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.neighbors import brute_force
from cuvs_tpu_torch.utils import tracing
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CONFIGS = os.path.join(ROOT, "cuvs_tpu", "bench", "configs")
CONFIGS = ["brute_force", "cagra", "ivf_flat", "ivf_pq", "ivf_rabitq", "ivf_sq"]
DS = "synthetic-100k-96"
RECALL_TOL = 0.05


@pytest.fixture
def few_queries(monkeypatch):
    """Both packages' DS with 1000 queries (the registry's 10,000 make each
    CPU search of the IVF-RaBitQ and IVF-SQ rows take seconds)."""
    for mod in (datasets, jax_datasets):
        monkeypatch.setitem(mod.REGISTRY, DS, dataclasses.replace(mod.REGISTRY[DS], n_query=1000))


def _mapped(cfg):
    """A reference config with its hooks named in the port's module."""
    cfg = json.loads(json.dumps(cfg))
    for kind, name in cfg.get("constraints", {}).items():
        cfg["constraints"][kind] = name.replace("cuvs_tpu.bench.", "cuvs_tpu_torch.bench.")
    return cfg


def _rows_as_dicts(rows):
    return [r.as_dict() for r in rows]


def _assert_rows_like_reference(got, ref, exact_recall=False):
    assert [r.params for r in got] == [r.params for r in ref]
    assert [(r.algo, r.dataset) for r in got] == [(r.algo, r.dataset) for r in ref]
    for g, r in zip(got, ref):
        assert g.qps > 0 and g.latency_ms > 0 and g.build_s >= 0
        if exact_recall:
            assert g.recall == r.recall
        else:
            assert abs(g.recall - r.recall) <= RECALL_TOL, (g.params, g.recall, r.recall)


# ---------------------------------------------------------------------------
# configs and constraint hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_bundled_config_is_the_reference_with_hooks_mapped(name):
    got = runner.load_config(name)
    assert got == _mapped(jax_runner.load_config(name))
    for hook in got.get("constraints", {}).values():
        assert hook.startswith("cuvs_tpu_torch.bench.constraints.")
        assert constraints.resolve(hook).__module__ == "cuvs_tpu_torch.bench.constraints"
    # the reference's file by path parses to the reference's dict
    assert runner.load_config(os.path.join(REF_CONFIGS, f"{name}.yaml")) == \
        jax_runner.load_config(name)


def test_resolve_maps_reference_hooks_and_refuses_the_jax_package():
    assert constraints.resolve("cuvs_tpu.bench.constraints.cagra_build") is constraints.cagra_build
    assert constraints.resolve("cuvs_tpu_torch.bench.constraints.ivf_pq_search") is \
        constraints.ivf_pq_search
    for name in ("cuvs_tpu.neighbors.brute_force.build", "cuvs_tpu.bench.runner.run",
                 "cuvs_tpu.bench.constraints.no_such_hook", "cuvs_tpu.bench.constraints._x"):
        with pytest.raises(ValueError):
            constraints.resolve(name)
    assert constraints.resolve("os.path.join") is os.path.join


_BUILD_PARAMS = st.fixed_dictionaries({}, optional={
    "pq_dim": st.integers(0, 200), "pq_bits": st.integers(0, 12),
    "graph_degree": st.integers(1, 128), "intermediate_graph_degree": st.integers(1, 128),
    "n_lists": st.integers(-2, 4096), "bits_per_dim": st.integers(-1, 12)})
_SEARCH_PARAMS = st.fixed_dictionaries({}, optional={
    "refine_ratio": st.floats(0.0, 8.0), "itopk_size": st.integers(1, 512),
    "n_probes": st.integers(1, 200)})


@pytest.mark.parametrize("hook", ["ivf_pq_build", "cagra_build", "ivf_flat_build",
                                  "ivf_rabitq_build"])
@settings(max_examples=60, deadline=None)
@given(params=_BUILD_PARAMS, dims=st.integers(1, 1024))
def test_build_hooks_agree_with_reference(hook, params, dims):
    assert getattr(constraints, hook)(params, dims) == getattr(jax_constraints, hook)(params, dims)


@pytest.mark.parametrize("hook", ["ivf_pq_search", "cagra_search"])
@settings(max_examples=60, deadline=None)
@given(params=_SEARCH_PARAMS, build=_BUILD_PARAMS, k=st.integers(1, 256),
       batch=st.integers(1, 10_000))
def test_search_hooks_agree_with_reference(hook, params, build, k, batch):
    assert getattr(constraints, hook)(params, build, k, batch) == \
        getattr(jax_constraints, hook)(params, build, k, batch)


@pytest.mark.parametrize("grid", [
    {}, {"n_probes": [1, 5]}, {"n_probes": [10, 20, 50], "refine_ratio": [1.0, 2.0]},
    {"z": [None, 0.97], "a": [1], "m": ["x", "y"]},
])
def test_expand_grid_matches_reference(grid):
    assert runner._expand_grid(grid) == jax_runner._expand_grid(grid)


# ---------------------------------------------------------------------------
# fronts and files
# ---------------------------------------------------------------------------

def _row_specs():
    return [("ivf_flat", "ds", 1.0, {"n_probes": p}, r, q, 1000.0 / q)
            for p, r, q in [(8, 0.8, 5000), (16, 0.9, 3000), (32, 0.95, 1500), (64, 0.95, 900),
                            (4, 0.7, 6000.5)]] + \
        [("hnsw_cpu", "ds", 2.0, {"build": {"M": 16}, "search": {"ef": e}}, r, q, 1000.0 / q)
         for e, r, q in [(32, 0.85, 800), (64, 0.93, 400), (128, 0.85, 300)]]


def test_pareto_csv_json_match_reference_byte_for_byte(tmp_path):
    mine = [runner.Row(*s) for s in _row_specs()]
    ref = [jax_runner.Row(*s) for s in _row_specs()]
    assert _rows_as_dicts(runner.pareto(mine)) == _rows_as_dicts(jax_runner.pareto(ref))
    sweep_rows = [dict(build=r.params, search={}, recall=r.recall, qps=r.qps,
                       latency_ms=r.latency_ms, build_s=r.build_s) for r in mine]
    assert sweep.pareto_frontier(sweep_rows) == jax_sweep.pareto_frontier(sweep_rows)
    for name, mine_fn, ref_fn in [("write_csv.csv", runner.write_csv, jax_runner.write_csv),
                                  ("export_csv.csv", plot.export_csv, jax_plot.export_csv),
                                  ("export_json.json", plot.export_json, jax_plot.export_json)]:
        mine_fn(mine, str(tmp_path / f"port_{name}"))
        ref_fn(ref, str(tmp_path / f"ref_{name}"))
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"ref_{name}").read_bytes()


# ---------------------------------------------------------------------------
# datasets: ground truth, its cache, download, the native read
# ---------------------------------------------------------------------------

def test_groundtruth_matches_reference_and_caches_read_across(tmp_path):
    ds = datasets.load(DS, max_rows=3000)
    jds = jax_datasets.load(DS, max_rows=3000)
    d, i = datasets.groundtruth(ds, k=10, gt_queries=64, device="cpu")
    rd, ri = jax_datasets.groundtruth(jds, k=10, gt_queries=64)
    assert d.dtype == rd.dtype == np.float32 and i.dtype == ri.dtype == np.int32
    np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(i, ri, rd)
    # each package reads the other's cache file (same name, same keys)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    pd_, pi_ = datasets.groundtruth(ds, k=10, gt_queries=64, cache_dir=str(port_dir),
                                    device="cpu")
    rd_, ri_ = jax_datasets.groundtruth(jds, k=10, gt_queries=64, cache_dir=str(ref_dir))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir)) == [
        f"{DS}-n3000-q64-k10.npz"]
    xd, xi = jax_datasets.groundtruth(jds, k=10, gt_queries=64, cache_dir=str(port_dir))
    np.testing.assert_array_equal(xd, pd_)
    np.testing.assert_array_equal(xi, pi_)
    yd, yi = datasets.groundtruth(ds, k=10, gt_queries=64, cache_dir=str(ref_dir), device="cpu")
    np.testing.assert_array_equal(yd, rd_)
    np.testing.assert_array_equal(yi, ri_)


def test_groundtruth_uses_provided_ids_as_reference():
    ds = datasets.load(DS, max_rows=500)
    ds.gt_ids = np.arange(40 * 20, dtype=np.int32).reshape(40, 20)
    jds = jax_datasets.load(DS, max_rows=500)
    jds.gt_ids = ds.gt_ids
    for args in [dict(k=10, gt_queries=32), dict(k=30, gt_queries=40)]:
        d, i = datasets.groundtruth(ds, **args)
        rd, ri = jax_datasets.groundtruth(jds, **args)
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(i, ri)
        assert not d.any()


def test_download_raises_as_reference(monkeypatch):
    for env in (None, "/data/sets"):
        if env is None:
            monkeypatch.delenv("CUVS_TPU_DATASET_DIR", raising=False)
        else:
            monkeypatch.setenv("CUVS_TPU_DATASET_DIR", env)
        for name, dest in [("sift-128-euclidean", None), ("deep-1B", "/somewhere")]:
            with pytest.raises(RuntimeError) as got:
                datasets.download(name, dest)
            with pytest.raises(RuntimeError) as ref:
                jax_datasets.download(name, dest)
            assert str(got.value) == str(ref.value)
    with pytest.raises(KeyError):
        datasets.download("no-such-dataset")


def _write_bin(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.asarray(arr.shape, np.uint32).tofile(f)
        arr.tofile(f)


def _stage_test_data(root):
    spec = datasets.REGISTRY["test-data"]
    rng = np.random.default_rng(0)
    _write_bin(root / spec.base_file,
               rng.standard_normal((spec.n_base, spec.dims)).astype(np.float32))
    _write_bin(root / spec.query_file, rng.standard_normal((8, spec.dims)).astype(np.float32))
    _write_bin(root / spec.gt_file, rng.integers(0, spec.n_base, (8, 10)).astype(np.int32))
    return spec


def test_large_fbin_is_read_through_the_host_library(tmp_path, monkeypatch):
    """Above _NATIVE_READ_BYTES an .fbin base is read by the port's own host
    library (BinDataset), with the same rows as the reference's reader."""
    spec = _stage_test_data(tmp_path)
    monkeypatch.setenv("CUVS_TPU_DATASET_DIR", str(tmp_path))
    opened = []
    real = datasets._NATIVE_READ_BYTES
    from cuvs_tpu_torch import io as cio

    class Spy(cio.BinDataset):
        def __init__(self, path):
            opened.append(path)
            super().__init__(path)

    monkeypatch.setattr(cio, "BinDataset", Spy)
    monkeypatch.setattr(datasets, "_NATIVE_READ_BYTES", 0)
    for rows in (None, 1000):
        got = datasets.load("test-data", max_rows=rows)
        ref = jax_datasets.load("test-data", max_rows=rows)
        np.testing.assert_array_equal(got.base, ref.base)
        np.testing.assert_array_equal(got.queries, ref.queries)
        assert (got.gt_ids is None) == (ref.gt_ids is None)
    assert opened == [str(tmp_path / spec.base_file)] * 2
    monkeypatch.setattr(datasets, "_NATIVE_READ_BYTES", real)
    datasets.load("test-data")
    assert len(opened) == 2  # a small file reads through numpy


# ---------------------------------------------------------------------------
# the CPU HNSW competitor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_hnsw_cpu_equals_reference(metric):
    rng = np.random.default_rng(5)
    x = make_blobs(rng, 3000, 24)
    q = make_blobs(rng, 40, 24)
    for seed in (0, 7):
        got = competitors.HnswCpu(M=12, ef_construction=80, metric=metric, seed=seed).build(x)
        ref = jax_competitors.HnswCpu(M=12, ef_construction=80, metric=metric,
                                      seed=seed).build(x)
        for ef in (16, 64):
            gd, gi = got.search(q, 10, ef=ef)
            rd, ri = ref.search(q, 10, ef=ef)
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gd, rd)


def test_hnsw_cpu_search_before_build_raises():
    with pytest.raises(RuntimeError):
        competitors.HnswCpu().search(np.zeros((1, 4), np.float32), 1)


# ---------------------------------------------------------------------------
# the runner, the config sweep, the in-memory sweep (own builds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,group", [("brute_force", "base"), ("ivf_flat", "tiny"),
                                        ("ivf_pq", "tiny"), ("ivf_rabitq", "tiny"),
                                        ("ivf_sq", "tiny"), ("cagra", "tiny")])
def test_run_config_rows_match_reference(name, group, tmp_path, few_queries):
    kw = dict(group=group, k=10, max_rows=3000, gt_queries=128, reps=1)
    got = runner.run_config(name, DS, cache_dir=str(tmp_path / "p"), device="cpu", **kw)
    ref = jax_runner.run_config(name, DS, cache_dir=str(tmp_path / "r"), **kw)
    assert len(got) == len(ref) > 0
    _assert_rows_like_reference(got, ref, exact_recall=name == "brute_force")


def test_run_matches_reference(tmp_path, few_queries):
    for algo, bp, grid in [("brute_force", {}, {"fused": [True, False]}),
                           ("ivf_flat", {"n_lists": 16, "seed": 0}, {"n_probes": [2, 16]}),
                           ("ivf_pq", {"n_lists": 16, "pq_dim": 24},
                            {"n_probes": [8], "refine_ratio": [1.0, 2.0]})]:
        kw = dict(build_params=bp, search_grid=grid, k=10, max_rows=5000, gt_queries=128, reps=1)
        got = runner.run(DS, algo, cache_dir=str(tmp_path / "p"), device="cpu", **kw)
        ref = jax_runner.run(DS, algo, cache_dir=str(tmp_path / "r"), **kw)
        _assert_rows_like_reference(got, ref, exact_recall=algo == "brute_force")
    with pytest.raises(ValueError):
        runner.run(DS, "no_such_algo", max_rows=500, gt_queries=8, device="cpu")


def test_run_hnsw_cpu_row_equals_reference(tmp_path, few_queries):
    kw = dict(build_params={"M": 8, "ef_construction": 40}, search_grid={"ef": [16, 64]}, k=10,
              max_rows=2000, gt_queries=64, reps=1)
    got = runner.run(DS, "hnsw_cpu", cache_dir=str(tmp_path / "p"), device="cpu", **kw)
    ref = jax_runner.run(DS, "hnsw_cpu", cache_dir=str(tmp_path / "r"), **kw)
    # the same C++ source on float32 rows: the same ids, so the same recall
    _assert_rows_like_reference(got, ref, exact_recall=True)


def test_run_sweep_matches_reference():
    ds = datasets.load(DS, max_rows=4000)
    x, q = ds.base.astype(np.float32), ds.queries[:300].astype(np.float32)
    for space, exact in [
        (dict(algo="brute_force", search={"fused": [False, True]}), True),
        (dict(algo="ivf_flat", build={"n_lists": [16, 32]}, search={"n_probes": [2, 8, 32]},
              constraint=lambda b, s: s["n_probes"] <= b["n_lists"]), False),
    ]:
        got = sweep.run_sweep(x, q, 10, space, reps=1, gt_queries=200, device="cpu")
        ref = jax_sweep.run_sweep(x, q, 10, space, reps=1, gt_queries=200)
        key = lambda r: (json.dumps(r["build"], sort_keys=True),  # noqa: E731
                         json.dumps(r["search"], sort_keys=True))
        assert sorted(map(key, got)) == sorted(map(key, ref))
        by_ref = {key(r): r for r in ref}
        for r in got:
            if exact:
                assert r["recall"] == by_ref[key(r)]["recall"]
            else:
                assert abs(r["recall"] - by_ref[key(r)]["recall"]) <= RECALL_TOL
            assert r["qps"] > 0 and r["build_s"] >= 0
        assert [r["recall"] for r in got] == sorted((r["recall"] for r in got), reverse=True)
        front = sweep.pareto_frontier(got)
        assert front[-1]["recall"] == got[0]["recall"]


def test_cli_rows_and_csv(tmp_path, capsys, few_queries):
    out_csv = str(tmp_path / "rows.csv")
    rows = cli.main(["--device", "cpu", "--dataset", DS, "--algo", "ivf_flat", "--algo",
                     "ivf_flat", "--max-rows", "2000", "--reps", "1", "--build-params",
                     '{"n_lists": 16}', "--search-grid", '{"n_probes": [4, 16]}',
                     "--cache-dir", str(tmp_path), "--csv", out_csv, "--pareto"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == _rows_as_dicts(rows)
    assert 1 <= len(rows) <= 2  # one ivf_flat pass (repeats dropped), then its front
    with open(out_csv) as f:
        got = list(csv.DictReader(f))
    assert list(got[0]) == ["algo", "dataset", "build_s", "params", "recall", "qps",
                            "latency_ms"]
    assert [r["params"] for r in got] == [json.dumps(r.params) for r in rows]
    assert cli.DEFAULT_GRIDS == __import__("cuvs_tpu.bench.__main__",
                                           fromlist=["DEFAULT_GRIDS"]).DEFAULT_GRIDS


def test_cli_runs_with_jax_and_the_jax_package_unimportable(tmp_path):
    """The reference's YAML by path, with ``import jax`` and ``import
    cuvs_tpu`` made to fail: the port's CLI runs to its end."""
    out_csv = tmp_path / "rows.csv"
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['cuvs_tpu'] = None\n"
            f"sys.argv = ['cuvs_tpu_torch.bench', '--device', 'cpu', '--config', "
            f"{os.path.join(REF_CONFIGS, 'ivf_flat.yaml')!r}, '--group', 'tiny', "
            f"'--max-rows', '2000', '--reps', '1', '--cache-dir', {str(tmp_path)!r}, "
            f"'--csv', {str(out_csv)!r}]\n"
            "runpy.run_module('cuvs_tpu_torch.bench', run_name='__main__')\n"
            "assert sys.modules['jax'] is None and sys.modules['cuvs_tpu'] is None\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [json.loads(r["params"])["search"]["n_probes"] for r in rows] == [2, 8, 16]
    with open(out_csv) as f:
        assert len(list(csv.DictReader(f))) == 3


# ---------------------------------------------------------------------------
# counterparts of the reference's bench tests (tests/test_sparse_and_bench.py)
# ---------------------------------------------------------------------------

def test_bench_yaml_config_sweep(tmp_path, few_queries):
    rows = runner.run_config(
        "ivf_flat", DS, group="tiny", k=5,
        max_rows=2000, gt_queries=32, reps=1, cache_dir=str(tmp_path), device="cpu",
    )
    assert len(rows) == 3  # 1 build combo x 3 n_probes
    assert all(r.params["build"] == {"n_lists": 16} for r in rows)
    assert {r.params["search"]["n_probes"] for r in rows} == {2, 8, 16}
    assert all(r.qps > 0 and 0 <= r.recall <= 1 for r in rows)
    assert not constraints.ivf_pq_build({"pq_dim": 999}, 96)
    assert constraints.ivf_pq_build({"pq_dim": 48}, 96)


def test_bench_runner_and_pareto(tmp_path, few_queries):
    rows = runner.run(
        DS, "ivf_flat", build_params={"n_lists": 16, "seed": 0},
        search_grid={"n_probes": [2, 16]}, k=10, max_rows=5000, gt_queries=128, reps=1,
        cache_dir=str(tmp_path), device="cpu",
    )
    assert len(rows) == 2
    r2, r16 = rows
    assert r16.recall >= r2.recall
    assert all(r.qps > 0 and r.latency_ms > 0 for r in rows)
    front = runner.pareto(rows)
    assert front[0].recall == max(r.recall for r in rows)
    p = str(tmp_path / "rows.csv")
    runner.write_csv(rows, p)
    with open(p) as f:
        got = list(csv.DictReader(f))
    assert len(got) == 2 and got[0]["algo"] == "ivf_flat"


def test_bench_dataset_registry():
    ds = datasets.load(DS, max_rows=1000)
    assert ds.base.shape == (1000, 96)
    assert ds.synthetic
    with pytest.raises(ValueError):
        datasets.load("no-such-dataset")


def test_groundtruth_cache(tmp_path):
    ds = datasets.load(DS, max_rows=2000)
    d1, i1 = datasets.groundtruth(ds, k=5, gt_queries=32, cache_dir=str(tmp_path), device="cpu")
    d2, i2 = datasets.groundtruth(ds, k=5, gt_queries=32, cache_dir=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(i1, i2)


def test_truncated_load_drops_provided_groundtruth(tmp_path, monkeypatch):
    _stage_test_data(tmp_path)
    monkeypatch.setenv("CUVS_TPU_DATASET_DIR", str(tmp_path))
    full = datasets.load("test-data")
    assert full.gt_ids is not None and not full.synthetic
    cut = datasets.load("test-data", max_rows=1000)
    assert cut.base.shape[0] == 1000
    assert cut.gt_ids is None


def test_hnsw_cpu_competitor():
    rng = np.random.default_rng(23)
    x = make_blobs(rng, 5000, 32)
    q = make_blobs(rng, 64, 32)
    h = competitors.HnswCpu(M=16, ef_construction=100, seed=0).build(x)
    d, i = h.search(q, 10, ef=256)
    gtd, gti = naive_knn(q, x, 10)
    rec = calc_recall(i, gti, d, gtd)
    assert rec >= 0.9, rec
    assert h.build_seconds is not None


def test_plot_pareto_and_export(tmp_path):
    pytest.importorskip("matplotlib")
    rows = [runner.Row(*s) for s in _row_specs()]
    png = str(tmp_path / "pareto.png")
    plot.plot_pareto(rows, png)
    assert os.path.getsize(png) > 1000
    plot.plot_pareto(rows, str(tmp_path / "latency.png"), mode="latency", title="t")
    assert os.path.getsize(tmp_path / "latency.png") > 1000
    plot.export_csv(rows, str(tmp_path / "rows.csv"))
    jp = str(tmp_path / "rows.json")
    plot.export_json(rows, jp)
    with open(jp) as f:
        data = json.load(f)
    assert len(data["benchmarks"]) == len(rows)
    assert data["benchmarks"][0]["items_per_second"] == 5000


# ---------------------------------------------------------------------------
# the last missing functions: kmeans_balanced.fit_predict, the profiler trace
# ---------------------------------------------------------------------------

def test_kmeans_balanced_fit_predict_agrees_with_reference():
    rng = np.random.default_rng(7)
    x = make_blobs(rng, 3000, 16, n_centers=30)
    labels, centers = kmeans_balanced.fit_predict(x, 24, seed=3, device="cpu")
    assert labels.dtype == torch.int32 and centers.shape == (24, 16)
    assert torch.equal(centers, kmeans_balanced.fit(x, 24, seed=3, device="cpu"))
    assert torch.equal(labels, kmeans_balanced.predict(x, centers, device="cpu"))
    # the reference's assignment to the same centers
    assert np.array_equal(labels.numpy(), np.asarray(jax_kmb.predict(x, centers.numpy())))
    # the RNGs differ: hold the port to the reference's balance, not its ids
    ref_labels, ref_centers = jax_kmb.fit_predict(x, 24, seed=3)
    assert np.asarray(ref_centers).shape == tuple(centers.shape)
    sizes = np.bincount(labels.numpy(), minlength=24)
    ref_sizes = np.bincount(np.asarray(ref_labels), minlength=24)
    assert sizes.max() <= max(1.5 * ref_sizes.max(), 2.5 * sizes.mean())
    params = kmeans_balanced.BalancedParams(n_clusters=24, seed=3)
    again, _ = kmeans_balanced.fit_predict(torch.from_numpy(x), 24, params)
    assert torch.equal(again, labels)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    tracing.start_profiler_trace(str(tmp_path))
    with pytest.raises(RuntimeError):
        tracing.start_profiler_trace(str(tmp_path))
    traced = tracing.traced("bench_span")(lambda a: a @ a.T)
    traced(torch.ones(64, 64))
    path = tracing.stop_profiler_trace()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "bench_span" in names
    with pytest.raises(RuntimeError):
        tracing.stop_profiler_trace()


@pytest.mark.parametrize("verbose", [True, False])
def test_exact_ground_truth_matches_reference(verbose, capsys):
    x = make_blobs(np.random.default_rng(5), 2000, 24, 8)
    q = x[:40] + 0.01
    ids = gt.exact_ground_truth(brute_force.build(x, device="cpu"), torch.from_numpy(q), 10,
                                verbose=verbose)
    ref = jax_gt.exact_ground_truth(jax_brute_force.build(x), q, 10, verbose=verbose)
    d_ref, _ = naive_knn(q, x, 10)
    ids_match_modulo_ties(ids, ref, d_ref)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("verbose", [True, False])
def test_exact_ground_truth_prints_the_disagreement_then_raises(verbose, capsys, monkeypatch):
    """Unlike the reference, a disagreement raises; ``verbose`` prints it
    first, in the reference's words."""
    x = make_blobs(np.random.default_rng(5), 2000, 24, 8)
    index = brute_force.build(x, device="cpu")
    real = brute_force.search

    def wrong_fused(idx, queries, k, **kw):
        d, i = real(idx, queries, k, **kw)
        return (d, torch.flip(i, [0])) if kw.get("fused") else (d, i)

    monkeypatch.setattr(brute_force, "search", wrong_fused)
    with pytest.raises(gt.GroundTruthMismatch):
        gt.exact_ground_truth(index, torch.from_numpy(x[:40]), 10, verbose=verbose)
    err = capsys.readouterr().err
    assert ("fused GT disagrees with unfused" in err) == verbose
