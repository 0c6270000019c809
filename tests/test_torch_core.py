"""The port's building blocks against the JAX package, on the CPU: distances,
selection, bitsets and filters, the fused L2 argmin, k-means, the IVF list
machinery, datasets, tracing, and the import boundary.

Tolerances: float32 results rtol 1e-5 / atol 1e-4 (same math, another
summation order); integer results, ids without ties and dataset arrays are
identical.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.bench import datasets as jax_datasets
from cuvs_tpu.cluster import kmeans_balanced as jax_kmb
from cuvs_tpu.core import bitset as jax_bitset
from cuvs_tpu.distance import fused_l2_nn as jax_fused
from cuvs_tpu.distance import pairwise as jax_pairwise
from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu.neighbors import ivf_common as jax_ivf
from cuvs_tpu.selection.select_k import merge_parts as jax_merge_parts
from cuvs_tpu.selection.select_k import select_k as jax_select_k
from cuvs_tpu_torch.bench import datasets
from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.core import bitset
from cuvs_tpu_torch.distance import fused_l2_nn, pairwise
from cuvs_tpu_torch.neighbors import filters, ivf_common
from cuvs_tpu_torch.selection import select_k
from cuvs_tpu_torch.utils.tracing import traced
from tests.utils import make_blobs

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)


def test_distance_type_values_match_reference():
    assert {m.name: int(m) for m in pairwise.DistanceType} == \
        {m.name: int(m) for m in jax_pairwise.DistanceType}
    for name in ("sqeuclidean", "euclidean", "cosine", "inner_product", "l1", 6, "L2Expanded"):
        assert int(pairwise.normalize_metric(name)) == int(jax_pairwise.normalize_metric(name))
        assert pairwise.is_min_close(name) == jax_pairwise.is_min_close(name)
    with pytest.raises(ValueError):
        pairwise.normalize_metric("no-such-metric")


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine"])
def test_expanded_distances_match_reference(metric):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((30, 24)).astype(np.float32)
    y = rng.standard_normal((50, 24)).astype(np.float32)
    ref = jax_pairwise.pairwise_distance(x, y, metric, compute_dtype=jnp.float32)
    got = pairwise._expanded(pairwise.normalize_metric(metric), torch.from_numpy(x),
                             torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert pairwise.matmul_precision(torch.float32) == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


def test_int_dots_are_exact():
    rng = np.random.default_rng(1)
    a = rng.integers(-127, 128, (9, 2100)).astype(np.int8)  # > 1024 dims: chunked
    b = rng.integers(-127, 128, (7, 2100)).astype(np.int8)
    got = pairwise.int_dots(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_matches_reference_including_ties(select_min):
    rng = np.random.default_rng(2)
    v = rng.integers(0, 6, (20, 40)).astype(np.float32)  # many ties
    ids = rng.integers(0, 10_000, (20, 40)).astype(np.int32)
    lens = rng.integers(0, 41, 20).astype(np.int32)
    for kw, tkw in ((dict(), dict()), (dict(indices=ids), dict(indices=torch.from_numpy(ids))),
                    (dict(len_i=lens), dict(len_i=torch.from_numpy(lens)))):
        rv, ri = jax_select_k(v, 7, select_min=select_min, **kw)
        tv, ti = select_k.select_k(torch.from_numpy(v), 7, select_min=select_min, **tkw)
        assert np.array_equal(tv.numpy(), np.asarray(rv))
        assert np.array_equal(ti.numpy(), np.asarray(ri))
    # rows shorter than k are padded with +/-inf and id 0
    tv, ti = select_k.select_k(torch.from_numpy(v[:, :3]), 5, select_min=select_min)
    assert np.isinf(tv.numpy()[:, 3:]).all() and (ti.numpy()[:, 3:] == 0).all()


def test_topk_keeps_no_view_of_the_sorted_block():
    """The k best are copies: a view would keep each [rows, n] sorted block
    alive while the caller holds the k best (an exact self-search of 100,000
    rows in one tile held 40.8 GiB of them on the card)."""
    from cuvs_tpu_torch.selection.select_k import topk

    v, i = topk(torch.rand((64, 5000)), 10, True)
    assert v.untyped_storage().nbytes() == v.numel() * 4
    assert i.untyped_storage().nbytes() == i.numel() * 8


def test_merge_parts_matches_reference():
    rng = np.random.default_rng(3)
    vals = np.sort(rng.standard_normal((3, 8, 5)).astype(np.float32), axis=-1)
    ids = rng.integers(0, 1000, (3, 8, 5)).astype(np.int32)
    rv, ri = jax_merge_parts(vals, ids, 6)
    tv, ti = select_k.merge_parts(torch.from_numpy(vals), torch.from_numpy(ids), 6)
    assert np.array_equal(tv.numpy(), np.asarray(rv)) and np.array_equal(ti.numpy(), np.asarray(ri))
    tv2, ti2 = select_k.merge_parts([torch.from_numpy(v) for v in vals],
                                    [torch.from_numpy(i) for i in ids], 6)
    assert torch.equal(tv, tv2) and torch.equal(ti, ti2)


def test_bitset_matches_reference():
    rng = np.random.default_rng(4)
    mask = rng.random(100) < 0.5
    ref = np.asarray(jax_bitset.bitset_from_mask(mask))
    got = bitset.bitset_from_mask(torch.from_numpy(mask))
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert torch.equal(bitset.as_words(ref), got)
    assert np.array_equal(bitset.bitset_to_mask(got, 100).numpy(), mask)
    ids = rng.integers(0, 100, 30)
    assert np.array_equal(bitset.bitset_test(got, torch.from_numpy(ids)).numpy(), mask[ids])
    assert int(bitset.bitset_count(got, 100)) == int(mask.sum())
    flipped = bitset.bitset_set(got, torch.tensor([1, 1, 99]), False)
    ref_flipped = np.asarray(jax_bitset.bitset_set(jnp.asarray(ref), jnp.array([1, 1, 99]), False))
    assert np.array_equal(flipped.numpy().view(np.uint32), ref_flipped)
    assert (bitset.bitset_create(64, device="cpu").numpy().view(np.uint32) == 0xFFFFFFFF).all()


@pytest.mark.parametrize("kind", ["bitset", "bitmap", "udf", "none"])
def test_filter_passes_matches_reference(kind):
    rng = np.random.default_rng(5)
    qids = np.arange(6)[:, None]
    sids = rng.integers(0, 70, (6, 9))
    if kind == "bitset":
        mask = rng.random(70) < 0.5
        jf, tf = jax_filters.from_mask(mask), filters.from_mask(torch.from_numpy(mask))
    elif kind == "bitmap":
        mask = rng.random((6, 70)) < 0.5
        jf, tf = jax_filters.from_mask(mask), filters.from_mask(torch.from_numpy(mask))
    elif kind == "udf":
        jf, tf = (jax_filters.udf_filter(lambda q, s: (q + s) % 3 == 0),
                  filters.udf_filter(lambda q, s: (q + s) % 3 == 0))
    else:
        jf, tf = jax_filters.no_filter(), filters.no_filter()
    ref = jax_filters.passes(jf, jnp.asarray(qids), jnp.asarray(sids))
    got = filters.passes(tf, torch.from_numpy(qids), torch.from_numpy(sids))
    if kind == "none":
        assert ref is None and got is None
    else:
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_fused_l2_argmin_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    c = rng.standard_normal((20, 16)).astype(np.float32)
    w = rng.uniform(1, 2, 20).astype(np.float32)
    for kw, tkw in ((dict(), dict()), (dict(center_weights=w), dict(center_weights=torch.from_numpy(w)))):
        rl, rd = jax_fused.fused_l2_argmin(x, c, row_tile=128, **kw)
        tl, td = fused_l2_nn.fused_l2_argmin(torch.from_numpy(x), torch.from_numpy(c),
                                             row_tile=128, **tkw)
        assert np.array_equal(tl.numpy(), np.asarray(rl))
        np.testing.assert_allclose(td.numpy(), np.asarray(rd), **TOL)


def test_kmeans_balanced_predict_matches_and_fit_is_balanced():
    rng = np.random.default_rng(7)
    x = make_blobs(rng, 3000, 16, n_centers=30)
    centers = kmeans_balanced.fit(torch.from_numpy(x), 24, seed=3)
    assert centers.shape == (24, 16) and torch.isfinite(centers).all()
    labels = kmeans_balanced.predict(torch.from_numpy(x), centers)
    assert np.array_equal(labels.numpy(), np.asarray(jax_kmb.predict(x, centers.numpy())))
    sizes = np.bincount(labels.numpy(), minlength=24)
    ref_sizes = np.bincount(np.asarray(jax_kmb.fit_predict(x, 24, seed=3)[0]), minlength=24)
    # the RNGs differ: hold the port to the reference's balance, not its ids
    assert sizes.max() <= max(1.5 * ref_sizes.max(), 2.5 * sizes.mean())
    again = kmeans_balanced.fit(torch.from_numpy(x), 24, seed=3)
    assert torch.equal(centers, again)  # seeded: reproducible


def test_ivf_common_matches_reference():
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 9, 200).astype(np.int32)
    jorder, jl = jax_ivf.sort_by_label(jnp.asarray(labels), 9, pad=128)
    torder, tl = ivf_common.sort_by_label(torch.from_numpy(labels), 9, pad=128)
    assert np.array_equal(torder.numpy(), np.asarray(jorder))
    for r, g in zip(jl, tl):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert ivf_common.round_window(0) == jax_ivf.round_window(0) == 128
    assert ivf_common.round_window(300) == jax_ivf.round_window(300)
    q = rng.standard_normal((10, 8)).astype(np.float32)
    c = rng.standard_normal((9, 8)).astype(np.float32)
    for metric in (0, 2, 6):
        m = jax_pairwise.DistanceType(metric)
        cn = np.linalg.norm(c, axis=1) if metric == 2 else (c * c).sum(1)
        rp = jax_ivf.coarse_search(jnp.asarray(q), jnp.asarray(c), jnp.asarray(cn), 4, m)
        tp = ivf_common.coarse_search(torch.from_numpy(q), torch.from_numpy(c),
                                      torch.from_numpy(cn), 4, pairwise.DistanceType(metric))
        assert np.array_equal(tp.numpy(), np.asarray(rp))
    arr = rng.standard_normal((300, 3)).astype(np.float32)
    starts = np.array([0, 5, 290], np.int32)  # the last start is clamped
    assert np.array_equal(
        ivf_common.window_gather(torch.from_numpy(arr), torch.from_numpy(starts), 16).numpy(),
        np.asarray(jax_ivf.window_gather(jnp.asarray(arr), jnp.asarray(starts), 16)))
    d = np.array([[4.0, np.inf, 9.0]], np.float32)
    assert np.array_equal(
        ivf_common.postprocess_distances(torch.from_numpy(d), pairwise.DistanceType(1)).numpy(),
        np.asarray(jax_ivf.postprocess_distances(jnp.asarray(d), jax_pairwise.DistanceType(1))))


@pytest.mark.parametrize("name", ["synthetic-100k-96", "sift-128-euclidean"])
def test_datasets_are_byte_identical_to_reference(name, monkeypatch):
    monkeypatch.delenv("CUVS_TPU_DATASET_DIR", raising=False)
    a = jax_datasets.load(name, max_rows=3000, seed=5)
    b = datasets.load(name, max_rows=3000, seed=5)
    assert a.base.tobytes() == b.base.tobytes() and a.queries.tobytes() == b.queries.tobytes()
    assert (a.metric, a.synthetic) == (b.metric, b.synthetic)
    assert set(datasets.REGISTRY) == set(jax_datasets.REGISTRY)


def test_datasets_read_bin_files(tmp_path, monkeypatch):
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    (tmp_path / "test-data").mkdir()
    with open(tmp_path / "test-data/ann_benchmarks_like.base.fbin", "wb") as f:
        np.array([6, 4], np.uint32).tofile(f)
        x.tofile(f)
    monkeypatch.setenv("CUVS_TPU_DATASET_DIR", str(tmp_path))
    ds = datasets.load("test-data", max_rows=5)
    assert not ds.synthetic and np.array_equal(ds.base, x[:5]) and ds.gt_ids is None


def test_traced_records_a_profiler_range():
    @traced("port::probe")
    def f(a):
        return a + 1

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert int(f(torch.ones(1))) == 2
    assert "port::probe" in {e.key for e in prof.key_averages()}


def test_import_pulls_in_neither_jax_nor_triton():
    code = ("import sys, cuvs_tpu_torch, cuvs_tpu_torch.interop; "
            "import cuvs_tpu_torch.neighbors.ivf_pq, cuvs_tpu_torch.neighbors.ivf_rabitq; "
            "bad = [m for m in ('jax', 'flax', 'triton') if m in sys.modules]; "
            "assert not bad, bad; "
            "from cuvs_tpu_torch.ops import _lib; "
            "assert _lib.lib.cache_info().currsize == 0")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
