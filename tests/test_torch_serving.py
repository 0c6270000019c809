"""The serving composition: tiered, offloaded and dynamically batched indexes,
and the big-ann dataset files, on the CPU against the JAX package and the
reference's own tests of them.

Exact searches (brute force, the hot tier, offloaded brute-force shards)
agree with the reference to rtol 1e-5 / atol 1e-4 in distance and in ids
except at ties within that tolerance. ANN tiers built by each package draw
other k-means numbers; where both must search one index, the reference's is
read from its own files. Dataset files must be byte-identical both ways.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from cuvs_tpu import io as jax_io
from cuvs_tpu.neighbors import brute_force as jax_bf
from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu.neighbors import ivf_flat as jax_ivf_flat
from cuvs_tpu.neighbors import offload as jax_offload
from cuvs_tpu.neighbors import tiered_index as jax_tiered
from cuvs_tpu_torch import io as cio
from cuvs_tpu_torch.io import native
from cuvs_tpu_torch.neighbors import (brute_force, dynamic_batching, filters, ivf_flat, ivf_pq,
                                      offload, refine, tiered_index)
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)

RNG = np.random.default_rng(55)
TOL = dict(rtol=1e-5, atol=1e-4)
BACKENDS = ["python", "native"]


def _same_results(td, ti, jd, ji, tol=TOL):
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(np.asarray(td), jd, **tol)
    ids_match_modulo_ties(np.asarray(ti), ji, jd, **tol)


# --------------------------------------------------------------------------- tiered


def test_tiered_index():
    """tests/test_extras.py::test_tiered_index on the port."""
    x = make_blobs(RNG, 6000, 16)
    q = make_blobs(RNG, 30, 16)
    t = tiered_index.build(ivf_flat, dataset=x[:4000],
                           ann_params=ivf_flat.IndexParams(n_lists=32, seed=0),
                           min_ann_rows=1000, device="cpu")
    assert t.ann_index is not None  # promoted at once (4000 >= 1000)
    t = tiered_index.extend(t, x[4000:])  # lands in the hot tier
    assert t.size == 6000 and t.bf_data.device.type == "cpu"
    d, i = tiered_index.search(t, q, 10, ann_kw=dict(n_probes=32))
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.95
    t = tiered_index.compact(t)
    assert t.bf_data is None and t.ann_rows == 6000
    d, i = tiered_index.search(t, q, 10, ann_kw=dict(n_probes=32))
    assert calc_recall(i.numpy(), gti) >= 0.95


def test_tiered_below_min_rows_is_the_hot_tier_alone():
    x = make_blobs(RNG, 500, 16)
    q = make_blobs(RNG, 10, 16)
    t = tiered_index.build(ivf_flat, dataset=x, min_ann_rows=1000, device="cpu")
    assert t.ann_index is None
    d, i = tiered_index.search(t, q, 10)
    _same_results(d, i, *jax_bf.search(jax_bf.build(x), q, 10))


def test_tiered_searches_the_reference_directory_as_the_reference(tmp_path):
    """The reference's tiered index read from its files: the same ANN tier and
    hot tier give the reference's merged top-k."""
    x = make_blobs(RNG, 1200, 16)
    extra = make_blobs(RNG, 60, 16)
    q = make_blobs(RNG, 12, 16)
    jt = jax_tiered.build(jax_ivf_flat, x, ann_params=jax_ivf_flat.IndexParams(n_lists=8, seed=0),
                          min_ann_rows=1000)
    jt = jax_tiered.extend(jt, extra)
    path = str(tmp_path / "tiered")
    jax_tiered.save(path, jt)
    t = tiered_index.load(path, device="cpu")
    assert t.module is ivf_flat and t.ann_params == ivf_flat.IndexParams(n_lists=8, seed=0)
    assert t.ann_rows == 1200 and t.bf_data.shape == (60, 16)
    d, i = tiered_index.search(t, q, 10, ann_kw=dict(n_probes=4, scan_algo="query_major"))
    _same_results(d, i, *jax_tiered.search(jt, q, 10, ann_kw=dict(n_probes=4)))


def test_tiered_roundtrip(tmp_path):
    """tests/test_serialize.py::test_tiered_roundtrip on the port; the
    reference reads the port's directory too."""
    x = make_blobs(RNG, 1200, 16)
    extra = make_blobs(RNG, 60, 16)
    q = make_blobs(RNG, 5, 16)
    t = tiered_index.build(ivf_flat, x, ann_params=ivf_flat.IndexParams(n_lists=8, seed=0),
                           min_ann_rows=1000, device="cpu")
    t = tiered_index.extend(t, extra)  # leaves a hot tier
    assert t.ann_index is not None and t.bf_data is not None
    path = str(tmp_path / "tiered")
    tiered_index.save(path, t)
    t2 = tiered_index.load(path, device="cpu")
    d1, i1 = tiered_index.search(t, q, 5, ann_kw=dict(n_probes=8))
    d2, i2 = tiered_index.search(t2, q, 5, ann_kw=dict(n_probes=8))
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    assert t2.min_ann_rows == t.min_ann_rows and t2.ann_rows == t.ann_rows
    jt = jax_tiered.load(path)
    assert jt.ann_rows == 1200 and np.asarray(jt.bf_data).shape == (60, 16)
    _same_results(*tiered_index.search(t, q, 5, ann_kw=dict(n_probes=8, scan_algo="query_major")),
                  *jax_tiered.search(jt, q, 5, ann_kw=dict(n_probes=8)))


def test_tiered_hot_tier_ignores_the_prefilter_as_the_reference():
    """A divergence of the reference kept by the port: the filter applies to
    the ANN tier only (tiered_index.py:103-105), so hot-tier rows the filter
    rejects are returned."""
    x = make_blobs(RNG, 1200, 16)
    extra = make_blobs(RNG, 40, 16)
    q = extra[:6] + 0.01
    keep = np.zeros(1240, bool)  # reject every row
    jt = jax_tiered.extend(jax_tiered.build(jax_bf, x, min_ann_rows=1000), extra)
    t = tiered_index.extend(tiered_index.build(brute_force, x, min_ann_rows=1000, device="cpu"),
                            extra)
    jd, ji = jax_tiered.search(jt, q, 5, prefilter=jax_filters.from_mask(keep))
    d, i = tiered_index.search(t, q, 5, prefilter=filters.from_mask(keep, device="cpu"))
    # atol 1e-3: a query 0.01 from a row of norm ~30 leaves ~1e-4 of the
    # expanded form's rounding in a distance of ~2e-3
    _same_results(d, i, jd, ji, dict(rtol=1e-5, atol=1e-3))
    finite = np.isfinite(d.numpy())
    assert finite[:, 0].all() and (i.numpy()[finite] >= 1200).all()


# --------------------------------------------------------------------------- offload


def test_offload_bf_exact():
    """tests/test_offload.py::test_offload_bf_exact on the port, and the
    reference's offloaded search."""
    x = make_blobs(RNG, 6000, 24)
    q = make_blobs(RNG, 32, 24)
    idx = offload.build(x, algo="brute_force", n_shards=4, device="cpu")
    assert len(idx.shards) == 4 and idx.size == 6000
    assert idx.shards[0].dataset.device.type == "cpu"  # shard tensors live on the host
    d, i = offload.search(idx, q, 10, device="cpu")
    assert isinstance(d, np.ndarray) and isinstance(i, np.ndarray)
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i, gti, d, gtd) >= 0.999
    _same_results(d, i, *jax_offload.search(jax_offload.build(x, "brute_force", n_shards=4), q, 10))


def test_offload_ivf_pq_from_reader(tmp_path):
    """Out-of-core build path: shards read from a .fbin file reader."""
    x = make_blobs(RNG, 8000, 32)
    q = make_blobs(RNG, 24, 32)
    p = str(tmp_path / "base.fbin")
    cio.write_bin(p, x)
    with cio.BinDataset(p) as reader:
        idx = offload.build(reader, algo="ivf_pq", n_shards=3, n_lists=16, pq_dim=16, seed=0,
                            device="cpu")
    assert idx.size == 8000 and idx.row_offsets == [0, 2667, 5334]
    d, cand = offload.search(idx, q, 30, device="cpu", n_probes=16)
    rd, ri = refine.refine(x, q, cand, 10, device="cpu")
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(ri.numpy(), gti) >= 0.9


def test_offload_roundtrip_and_the_reference_directory(tmp_path):
    x = make_blobs(RNG, 3000, 16)
    q = make_blobs(RNG, 8, 16)
    idx = offload.build(x, algo="ivf_flat", n_shards=2, n_lists=8, seed=0, device="cpu")
    d1, i1 = offload.search(idx, q, 5, device="cpu", n_probes=8)
    p = str(tmp_path / "offload")
    offload.save(p, idx)
    d2, i2 = offload.search(offload.load(p), q, 5, device="cpu", n_probes=8)
    np.testing.assert_array_equal(i1, i2)
    jidx = jax_offload.build(x, "ivf_flat", n_shards=2, n_lists=8, seed=0)
    jax_offload.save(str(tmp_path / "ref"), jidx)
    loaded = offload.load(str(tmp_path / "ref"))
    assert loaded.row_offsets == [0, 1500] and loaded.n_rows == 3000
    _same_results(*offload.search(loaded, q, 5, device="cpu", n_probes=4,
                                  scan_algo="query_major"),
                  *jax_offload.search(jidx, q, 5, n_probes=4))


def test_host_refined_index():
    """tests/test_offload.py::test_host_refined_index on the port: the
    refined search is refine_host over the device index's candidates."""
    x = make_blobs(RNG, 6000, 24)
    q = make_blobs(RNG, 32, 24)
    idx = offload.build_host_refined(x, algo="ivf_flat", n_lists=16, seed=0,
                                     storage_dtype=torch.int8, device="cpu")
    d, i = offload.search_refined(idx, q, 10, refine_ratio=4, n_probes=16)
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.95
    cand = ivf_flat.search(idx.device_index, torch.from_numpy(q), 40, n_probes=16)[1]
    hd, hi = refine.refine_host(x, torch.from_numpy(q), cand, 10)
    assert torch.equal(hi, i) and torch.equal(hd, d)


def test_host_refined_index_from_a_reader(tmp_path):
    x = make_blobs(RNG, 3000, 16)
    q = make_blobs(RNG, 16, 16)
    p = str(tmp_path / "base.fbin")
    cio.write_bin(p, x)
    with cio.BinDataset(p) as reader:
        idx = offload.build_host_refined(reader, algo="ivf_pq", n_lists=8, pq_dim=8, seed=0,
                                         device="cpu")
        d, i = offload.search_refined(idx, q, 10, refine_ratio=4, n_probes=8)
        unrefined = ivf_pq.search(idx.device_index, torch.from_numpy(q), 10, n_probes=8)[1]
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti) >= calc_recall(unrefined.numpy(), gti)


# --------------------------------------------------------------------------- dynamic batching


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_matches_direct(backend):
    x = make_blobs(RNG, 2000, 16)
    idx = brute_force.build(x, device="cpu")
    bs = dynamic_batching.wrap(brute_force, idx, dim=16, backend=backend,
                               params=dynamic_batching.BatchParams(k=5, max_batch_size=32,
                                                                   dispatch_timeout_ms=5))
    q = make_blobs(RNG, 10, 16)
    d, i = bs.search(q)
    assert isinstance(d, np.ndarray) and isinstance(i, np.ndarray)
    dd, ii = brute_force.search(idx, torch.from_numpy(q), 5)
    np.testing.assert_array_equal(i, ii.numpy())
    _same_results(d, i, *jax_bf.search(jax_bf.build(x), q, 5))
    bs.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_concurrent_requests_aggregate(backend):
    x = make_blobs(RNG, 3000, 8)
    idx = brute_force.build(x, device="cpu")
    bs = dynamic_batching.wrap(brute_force, idx, dim=8, backend=backend,
                               params=dynamic_batching.BatchParams(k=3, max_batch_size=64,
                                                                   dispatch_timeout_ms=20))
    gtd_all, gti_all = naive_knn(x[:64], x, 3)
    futs = [bs.submit(x[j][None]) for j in range(64)]
    ids = np.concatenate([f.result(timeout=30)[1] for f in futs], axis=0)
    assert calc_recall(ids, gti_all) >= 0.999
    assert bs.stats()["max_batch_rows"] > 1  # requests shared a dispatch
    bs.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_row_requests_across_batches(backend):
    """Requests larger than max_batch_size span several dispatches and still
    resolve with all rows in order."""
    x = make_blobs(RNG, 2000, 8)
    idx = brute_force.build(x, device="cpu")
    bs = dynamic_batching.wrap(brute_force, idx, dim=8, backend=backend,
                               params=dynamic_batching.BatchParams(k=3, max_batch_size=16,
                                                                   dispatch_timeout_ms=5))
    d, i = bs.search(x[:40], timeout=60)
    dd, ii = brute_force.search(idx, torch.from_numpy(x[:40]), 3)
    np.testing.assert_array_equal(i, ii.numpy())
    bs.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_error_propagates(backend):
    def broken(q):
        raise RuntimeError("boom")

    bs = dynamic_batching.BatchedSearcher(
        broken, dim=4, backend=backend,
        params=dynamic_batching.BatchParams(k=1, max_batch_size=4, dispatch_timeout_ms=1))
    fut = bs.submit(np.zeros((1, 4), np.float32))
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(timeout=10)
    bs.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_dim_mismatch_rejected(backend):
    idx = brute_force.build(make_blobs(RNG, 100, 8), device="cpu")
    bs = dynamic_batching.wrap(brute_force, idx, dim=8, backend=backend)
    with pytest.raises(ValueError, match="dim"):
        bs.submit(np.zeros((1, 5), np.float32))
    bs.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_auto_tune_adapts_timeout(backend):
    """auto_tune pulls the dispatch timeout toward a fraction of the measured
    service time and exposes rolling latency percentiles (asserting only
    what tests/test_dynamic_batching.py:97-124 asserts)."""

    def slow_search(q):
        time.sleep(0.02)  # 20 ms service time
        return np.zeros((q.shape[0], 5), np.float32), np.zeros((q.shape[0], 5), np.int32)

    p = dynamic_batching.BatchParams(k=5, max_batch_size=16, dispatch_timeout_ms=50.0,
                                     auto_tune=True, auto_tune_fraction=0.5)
    s = dynamic_batching.BatchedSearcher(slow_search, dim=8, params=p, backend=backend)
    try:
        for _ in range(6):
            s.search(np.zeros((2, 8), np.float32))
        st = s.stats()
        assert st["n_requests"] >= 6
        assert st["latency_p95_ms"] is not None
        assert st["dispatch_timeout_ms"] < 25.0, st
    finally:
        s.close()


def test_auto_backend_is_native():
    bs = dynamic_batching.BatchedSearcher(lambda q: (q[:, :1], q[:, :1]), dim=4)
    try:
        assert bs._native is not None
    finally:
        bs.close()
    with pytest.raises(ValueError, match="backend"):
        dynamic_batching.BatchedSearcher(lambda q: q, dim=4, backend="other")


def test_many_threads_submitting_resolve_every_request():
    x = make_blobs(RNG, 1000, 8)
    idx = brute_force.build(x, device="cpu")
    want = brute_force.search(idx, torch.from_numpy(x[:200]), 4)[1].numpy()
    bs = dynamic_batching.wrap(brute_force, idx, dim=8,
                               params=dynamic_batching.BatchParams(k=4, max_batch_size=64))
    got = [None] * 200

    def client(c):
        for j in range(c, 200, 8):
            got[j] = bs.submit(x[j]).result(timeout=30)[1][0]
    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    bs.close()
    np.testing.assert_array_equal(np.stack(got), want)


# --------------------------------------------------------------------------- io


def test_host_library_is_built_under_the_port_build_dir():
    assert cio.native_available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "cuvs_tpu_torch"
    assert not str(path).endswith("libcuvs_tpu_native.so")


@pytest.mark.parametrize("ext,dtype", [(".fbin", np.float32), (".u8bin", np.uint8),
                                       (".ibin", np.int32), (".i8bin", np.int8)])
def test_roundtrip_both_ways(tmp_path, ext, dtype):
    rng = np.random.default_rng(0)
    if dtype == np.float32:
        x = rng.standard_normal((1000, 17)).astype(dtype)
    else:
        x = rng.integers(0, 100, (1000, 17)).astype(dtype)
    p = str(tmp_path / f"data{ext}")
    cio.write_bin(p, x)
    with cio.BinDataset(p) as d:
        assert d.shape == (1000, 17)
        np.testing.assert_array_equal(d.read(), x)
        np.testing.assert_array_equal(d.read(100, 50), x[100:150])
        np.testing.assert_array_equal(d.read(0, 1000, n_threads=4), x)
    np.testing.assert_array_equal(jax_io.load_bin(p), x)  # the reference reads the port's
    q = str(tmp_path / f"ref{ext}")
    jax_io.write_bin(q, x)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(cio.load_bin(q), x)


def test_batches(tmp_path):
    x = np.arange(100 * 4, dtype=np.float32).reshape(100, 4)
    p = str(tmp_path / "b.fbin")
    cio.write_bin(p, x)
    with cio.BinDataset(p) as d:
        got = np.concatenate(list(d.batches(33)), axis=0)
    np.testing.assert_array_equal(got, x)


def test_out_of_bounds(tmp_path):
    p = str(tmp_path / "o.fbin")
    cio.write_bin(p, np.zeros((10, 4), np.float32))
    with cio.BinDataset(p) as d:
        with pytest.raises(IndexError):
            d.read(5, 10)


def test_corrupt_header_rejected(tmp_path):
    p = tmp_path / "bad.fbin"
    with open(p, "wb") as f:  # header claims 1M rows but the file is tiny
        np.asarray([1_000_000, 128], np.int32).tofile(f)
        np.zeros(10, np.float32).tofile(f)
    with pytest.raises(OSError):
        cio.BinDataset(str(p))
    with pytest.raises(ValueError, match="extension"):
        cio.write_bin(str(tmp_path / "x.bin"), np.zeros((2, 2)))


def test_batch_queue_native():
    import ctypes

    lib = native.lib()
    q = lib.cuvs_tpu_queue_create(64, 4)
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert lib.cuvs_tpu_queue_push(q, rows.ctypes.data_as(ctypes.c_void_p), 3, 7) == 3
    out = np.zeros((8, 4), np.float32)
    tickets = np.zeros(8, np.int64)
    args = (out.ctypes.data_as(ctypes.c_void_p), tickets.ctypes.data_as(ctypes.c_void_p), 8, 1000)
    assert lib.cuvs_tpu_queue_pop_batch(q, *args) == 3
    np.testing.assert_array_equal(out[:3], rows)
    assert (tickets[:3] == 7).all()
    assert lib.cuvs_tpu_queue_pop_batch(q, *args) == 0  # an empty pop times out with 0
    lib.cuvs_tpu_queue_destroy(q)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: without a compiler the host library raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.build()
    assert not os.listdir(tmp_path)
