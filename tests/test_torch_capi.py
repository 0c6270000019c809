"""The C ABI over the port: the bridge, the port's C library and the
execution-policy handle, on the CPU.

Each bridge function is called from Python with host buffers (numpy arrays
passed by address, as the C library passes them) after ``init("cpu")``, and
its result equals the direct call of the port's module (ids equal, distances
bit-identical: the same call on the same tensors). The port's C library is
built from the untouched ``capi/cuvs_tpu_c.cpp`` and the untouched
``capi/c_test.c`` walks the whole ABI against it, in a copy whose
``/tmp/capi_`` paths point into the test's own directory, with JAX made
unimportable: the ABI path reaches no JAX.
"""

import os
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

from cuvs_tpu_torch import capi, capi_bridge, mg
from cuvs_tpu_torch.core import Resources, resources
from cuvs_tpu_torch.neighbors import (all_neighbors, brute_force, cagra, filters, hnsw, ivf_flat,
                                      nn_descent, refine, tiered_index, vamana)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, NQ, K = 600, 8, 6, 5


@pytest.fixture
def bridge(monkeypatch):
    monkeypatch.setattr(capi_bridge, "_DEVICE", None)
    capi_bridge.init("cpu")
    return capi_bridge


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x, np.ascontiguousarray(x[:NQ] + 0.01)


def _out():
    return np.zeros((NQ, K), np.float32), np.zeros((NQ, K), np.int32)


def _assert_same(out_d, out_i, d, i):
    np.testing.assert_array_equal(out_i, i.to(torch.int32).numpy())
    np.testing.assert_array_equal(out_d, d.float().numpy())


def test_init_picks_the_device(monkeypatch):
    monkeypatch.setattr(capi_bridge, "_DEVICE", None)
    assert capi_bridge.init("cpu") and capi_bridge._device() == torch.device("cpu")
    assert capi_bridge.sync()
    with pytest.raises(ValueError):
        capi_bridge.init("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("", "gpu", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            capi_bridge.init(name)


@pytest.mark.parametrize("algo,params", [("brute_force", {}), ("ivf_flat", {"n_lists": 8}),
                                         ("cagra", {"graph_degree": 16,
                                                    "intermediate_graph_degree": 32})])
def test_build_and_search_equal_direct_calls(bridge, data, algo, params):
    import json

    x, q = data
    handle = bridge.build(algo, "sqeuclidean", json.dumps(params), x.ctypes.data, N, D)
    assert handle[0] == algo
    out_d, out_i = _out()
    sp = {"n_probes": 8} if algo == "ivf_flat" else {}
    bridge.search(handle, json.dumps(sp), q.ctypes.data, NQ, D, K, out_d.ctypes.data,
                  out_i.ctypes.data)
    module = {"brute_force": brute_force, "ivf_flat": ivf_flat, "cagra": cagra}[algo]
    direct = module.build(torch.from_numpy(x), metric="sqeuclidean", **params)
    _assert_same(out_d, out_i, *module.search(direct, torch.from_numpy(q), K, **sp))


@pytest.mark.parametrize("dtype", ["int8", "uint8", "float16", "bfloat16"])
def test_typed_build_and_search(bridge, data, dtype):
    x, q = data
    if dtype in ("bfloat16", "float16"):  # 16-bit floats cross as their words
        xt = torch.from_numpy(x).to(capi_bridge._DTYPES[dtype])
        xb = xt.view(torch.int16).numpy().copy()
        qt = torch.from_numpy(q).to(xt.dtype)
        qb = qt.view(torch.int16).numpy().copy()
    else:
        xb = np.clip(x * 40 + (100 if dtype == "uint8" else 0), -127, 255).astype(dtype)
        qb = np.ascontiguousarray(xb[:NQ])
        xt, qt = torch.from_numpy(xb), torch.from_numpy(qb)
    handle = bridge.build_typed("brute_force", "sqeuclidean", "{}", xb.ctypes.data, N, D, dtype)
    assert handle[1].dataset.dtype == xt.dtype
    out_d, out_i = _out()
    bridge.search_typed(handle, "{}", qb.ctypes.data, NQ, D, dtype, K, out_d.ctypes.data,
                        out_i.ctypes.data)
    _assert_same(out_d, out_i, *brute_force.search(brute_force.build(xt), qt, K))


def test_params_name_torch_dtypes():
    assert capi_bridge._params('{"lut_dtype": "int8", "n_probes": 3, "mode": "int8"}') == {
        "lut_dtype": torch.int8, "n_probes": 3, "mode": "int8"}


def test_serialize_round_trip_and_extend(bridge, data, tmp_path):
    x, q = data
    handle = bridge.build("ivf_flat", "sqeuclidean", '{"n_lists": 8}', x.ctypes.data, N - 100, D)
    tail = np.ascontiguousarray(x[N - 100:])
    handle = bridge.extend(handle, tail.ctypes.data, 100, D, "float32")
    assert handle[1].n_rows == N
    path = str(tmp_path / "index.npz")
    bridge.serialize(handle, path)
    loaded = bridge.deserialize(path)
    assert loaded[0] == "ivf_flat"
    a, b = _out()
    c, e = _out()
    for h, (od, oi) in ((handle, (a, b)), (loaded, (c, e))):
        bridge.search(h, '{"n_probes": 8}', q.ctypes.data, NQ, D, K, od.ctypes.data,
                      oi.ctypes.data)
    np.testing.assert_array_equal(b, e)
    np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="extend"):
        bridge.extend(bridge.build("brute_force", "sqeuclidean", "{}", x.ctypes.data, N, D),
                      tail.ctypes.data, 100, D, "float32")


@pytest.mark.parametrize("filter_type", [1, 2])
def test_search_filtered(bridge, data, filter_type):
    x, q = data
    handle = bridge.build("brute_force", "sqeuclidean", "{}", x.ctypes.data, N, D)
    n_words = (N + 31) // 32
    rows = 1 if filter_type == 1 else NQ
    words = np.full(rows * n_words, 0xAAAAAAAA, np.uint32)  # odd rows pass
    out_d, out_i = _out()
    bridge.search_filtered(handle, "{}", q.ctypes.data, NQ, D, "float32", K, filter_type,
                           words.ctypes.data, rows * n_words, out_d.ctypes.data,
                           out_i.ctypes.data)
    assert (out_i % 2 == 1).all()
    wt = torch.from_numpy(words.view(np.int32))
    flt = filters.bitset_filter(wt) if filter_type == 1 else filters.bitmap_filter(
        wt.reshape(NQ, -1))
    _assert_same(out_d, out_i, *brute_force.search(handle[1], torch.from_numpy(q), K,
                                                   prefilter=flt))


@pytest.mark.parametrize("kind", ["nn_descent", "all_neighbors"])
def test_knn_graph(bridge, data, kind):
    x, _ = data
    gk = 6
    graph = np.zeros((N, gk), np.int32)
    dist = np.zeros((N, gk), np.float32)
    params = '{"max_iterations": 4}' if kind == "nn_descent" else '{"algo": "brute_force"}'
    bridge.knn_graph(kind, "sqeuclidean", params, x.ctypes.data, N, D, "float32", gk,
                     graph.ctypes.data, dist.ctypes.data)
    xt = torch.from_numpy(x)
    if kind == "nn_descent":
        g, gd = nn_descent.build(xt, nn_descent.IndexParams(graph_degree=gk, metric="sqeuclidean",
                                                             max_iterations=4))
    else:
        g, gd = all_neighbors.build(xt, gk, all_neighbors.AllNeighborsParams(
            metric="sqeuclidean", algo="brute_force"))
    np.testing.assert_array_equal(graph, g.numpy())
    np.testing.assert_array_equal(dist, gd.numpy())


def test_refine(bridge, data):
    x, q = data
    cand = np.ascontiguousarray(np.random.default_rng(1).integers(0, N, (NQ, 12)), np.int32)
    out_d, out_i = _out()
    bridge.refine("sqeuclidean", x.ctypes.data, N, D, "float32", q.ctypes.data, NQ, D, "float32",
                  cand.ctypes.data, NQ, 12, K, out_d.ctypes.data, out_i.ctypes.data)
    _assert_same(out_d, out_i, *refine.refine(torch.from_numpy(x), torch.from_numpy(q),
                                              torch.from_numpy(cand), K, metric="sqeuclidean"))


def test_tiered_build_and_compact(bridge, data):
    x, q = data
    handle = bridge.tiered_build("ivf_flat", "sqeuclidean", '{"n_lists": 8}', 512, x.ctypes.data,
                                 N, D, "float32")
    assert handle[0] == "tiered" and handle[1].ann_rows == N
    direct = tiered_index.build(ivf_flat, torch.from_numpy(x),
                                ivf_flat.IndexParams(metric="sqeuclidean", n_lists=8),
                                min_ann_rows=512, metric="sqeuclidean")
    out_d, out_i = _out()
    bridge.search(handle, '{"n_probes": 8}', q.ctypes.data, NQ, D, K, out_d.ctypes.data,
                  out_i.ctypes.data)
    _assert_same(out_d, out_i, *tiered_index.search(direct, torch.from_numpy(q), K, n_probes=8))
    compacted = bridge.tiered_compact(handle)
    assert compacted[0] == "tiered"


def test_vamana_and_hnsw_files(bridge, data, tmp_path):
    x, q = data
    v = bridge.build("vamana", "sqeuclidean", "{}", x.ctypes.data, N, D)
    bridge.vamana_serialize(v, str(tmp_path / "a.bin"))
    vamana.serialize(vamana.build(torch.from_numpy(x), metric="sqeuclidean"),
                     str(tmp_path / "b.bin"))
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    c = bridge.build("cagra", "sqeuclidean", '{"graph_degree": 16, "intermediate_graph_degree": '
                     '32}', x.ctypes.data, N, D)
    bridge.hnsw_from_cagra(c, str(tmp_path / "h.bin"), "none", 200)
    hnsw.from_cagra(c[1], str(tmp_path / "h2.bin"), hnsw.HnswParams(hierarchy="none"))
    assert (tmp_path / "h.bin").read_bytes() == (tmp_path / "h2.bin").read_bytes()
    h = bridge.hnsw_load(str(tmp_path / "h.bin"), "sqeuclidean")
    assert h[0] == "hnsw"
    out_d, out_i = _out()
    bridge.search(h, '{"ef": 32}', q.ctypes.data, NQ, D, K, out_d.ctypes.data, out_i.ctypes.data)
    direct = hnsw.load(str(tmp_path / "h.bin"), metric="sqeuclidean", device="cpu")
    _assert_same(out_d, out_i, *hnsw.search(direct, torch.from_numpy(q), K, ef=32))


def test_mg_on_the_host(bridge, data, tmp_path):
    x, q = data
    index = bridge.mg_build("brute_force", "sharded", "sqeuclidean", "{}", x.ctypes.data, N, D,
                            "float32")
    assert [s.device.type for s in index.shards] == ["cpu"]
    out_d, out_i = _out()
    bridge.mg_search(index, "{}", q.ctypes.data, NQ, D, "float32", K, out_d.ctypes.data,
                     out_i.ctypes.data)
    direct = mg.build(torch.from_numpy(x), "brute_force", "sharded", devices=["cpu"],
                      metric="sqeuclidean")
    _assert_same(out_d, out_i, *mg.search(direct, torch.from_numpy(q), K))
    bridge.mg_serialize(index, str(tmp_path / "mg"))
    back = bridge.mg_deserialize(str(tmp_path / "mg"))
    od2, oi2 = _out()
    bridge.mg_search(back, "{}", q.ctypes.data, NQ, D, "float32", K, od2.ctypes.data,
                     oi2.ctypes.data)
    np.testing.assert_array_equal(oi2, out_i)


def test_bf16_buffers_are_viewed_bit_for_bit(bridge):
    vals = torch.tensor([[1.5, -2.25], [3.0, 0.1]], dtype=torch.bfloat16)
    words = vals.view(torch.int16).numpy().copy()
    t = capi_bridge._tensor(words.ctypes.data, (2, 2), "bfloat16")
    assert t.dtype == torch.bfloat16 and torch.equal(t, vals)


def test_resources_put_honours_device(monkeypatch):
    res = Resources(device=torch.device("cpu"), compute_dtype=torch.bfloat16, devices=["cpu"])
    t = res.put(np.ones((2, 3), np.float32))
    assert t.device.type == "cpu" and t.shape == (2, 3)
    assert resources.get(None) is resources.default_resources()
    assert resources.get(res) is res
    x = torch.zeros(3)
    assert Resources().put(x) is x  # a tensor stays where it is
    # the default handle puts host data on the card, and raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Resources().put(np.ones(3))


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_c_test_passes_against_the_port_library(tmp_path):
    """The untouched capi/c_test.c, its /tmp/capi_ paths moved into tmp_path,
    linked against the port's library and run with JAX unimportable."""
    src = open(os.path.join(ROOT, "capi", "c_test.c")).read()
    import re

    assert len(set(re.findall(r"/tmp/capi_\w+", src))) == 4
    (tmp_path / "c_test.c").write_text(src.replace("/tmp/capi_", f"{tmp_path}/capi_"))
    lib = capi.build()
    assert lib.parent.name == "_build" and lib.name.startswith("libcuvs_tpu_torch_c_")
    exe = capi.build_program(tmp_path / "c_test.c", tmp_path / "c_test")
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("JAX is not importable here")\n')
    env = capi.program_env(tmp_path / "stub")
    t0 = time.time()
    r = subprocess.run([exe], capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "C API smoke test PASSED" in r.stdout
    assert time.time() - t0 < 120
    assert (tmp_path / "capi_index.npz").exists() and (tmp_path / "capi_hnsw.bin").exists()
