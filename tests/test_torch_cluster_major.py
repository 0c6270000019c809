"""The unfused cluster-major scans: the port against the JAX package on
JAX-built indexes carried across (``cuvs_tpu_torch.interop``), on the CPU,
with the same probe lists given to both.

Tolerances: distances rtol 1e-5 / atol 1e-4 (the same f32 products summed in
another order), ids equal except where distances tie within that tolerance.
An int8 index's inner-product distances are integer dots times one scale and
must be identical (its L2 distances add |q|^2, a float sum, so they are held
to the tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu.neighbors import ivf_common as jax_ivf_common
from cuvs_tpu.neighbors import ivf_flat as jax_flat
from cuvs_tpu.neighbors import ivf_pq as jax_pq
from cuvs_tpu.neighbors import ivf_scan as jax_scan
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.distance.pairwise import normalize_metric
from cuvs_tpu_torch.neighbors import filters, ivf_flat, ivf_pq, ivf_scan
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import make_blobs

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    return make_blobs(rng, 3000, 40, n_centers=30), make_blobs(rng, 48, 40, n_centers=30)


def _flat_carried(j):
    return interop.ivf_flat_index_from_numpy(
        j.centers, j.center_norms, j.sorted_data, j.sorted_norms, j.lists.offsets, j.lists.sizes,
        j.lists.ids, j.lists.labels, j.q_scale, j.metric, j.window, j.n_rows, device="cpu")


def _pq_carried(j):
    return interop.ivf_pq_index_from_numpy(
        j.centers, j.center_norms, j.centers_rot, j.rotation, j.pq_centers, j.sorted_codes,
        j.lists.offsets, j.lists.sizes, j.lists.ids, j.lists.labels, j.metric, j.window,
        j.n_rows, j.pq_bits, j.sorted_codes_t, j.sorted_code_norms, device="cpu",
        codebook_gen=j.codebook_gen, pq_dim=j.pq_dim_static)


@pytest.fixture(scope="module")
def flat_indexes(data):
    x, _ = data
    return {"l2": jax_flat.build(x, n_lists=16, seed=0),
            "ip": jax_flat.build(x, n_lists=16, metric="inner_product", seed=0),
            "cosine": jax_flat.build(x, n_lists=16, metric="cosine", seed=0),
            "int8": jax_flat.build(x, n_lists=16, seed=0, storage_dtype=jnp.int8)}


def _sq_l2(x, y):  # a metric UDF written once for both frameworks
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


_CASES = {  # case -> (index, metric, prefilter?)
    "l2": ("l2", "sqeuclidean", False), "ip": ("ip", "inner_product", False),
    "cosine": ("cosine", "cosine", False), "udf": ("l2", _sq_l2, False),
    "int8_l2": ("int8", "sqeuclidean", False), "int8_ip": ("int8", "inner_product", False),
    "prefilter": ("l2", "sqeuclidean", True)}


# the reference's untiled scan takes no metric UDF
@pytest.mark.parametrize("case,tiled", [(c, t) for c in _CASES for t in (True, False)
                                        if t or c != "udf"])
def test_flat_scan_matches_reference(data, flat_indexes, case, tiled):
    x, q = data
    which, metric, filtered = _CASES[case]
    j = flat_indexes[which]
    jmetric = metric if callable(metric) else jax_flat.normalize_metric(metric)
    tmetric = metric if callable(metric) else normalize_metric(metric)
    probe_ids = jax_ivf_common.coarse_search(jnp.asarray(q), j.centers, j.center_norms, 6,
                                             j.metric)
    if filtered:
        mask = np.random.default_rng(43).random(x.shape[0]) < 0.5
        jflt, tflt = jax_filters.from_mask(mask), filters.from_mask(torch.from_numpy(mask))
    else:
        jflt, tflt = jax_filters.no_filter(), filters.no_filter()
    t = _flat_carried(j)
    qt, pt = torch.from_numpy(q), torch.from_numpy(np.array(probe_ids))
    if tiled:
        M, n_tiles, chunk = 8, 48 * 6 // 8 + 16 + 1, 7  # chunks with a remainder
        jd, ji = jax_scan.cluster_major_scan_tiled(
            j.sorted_data, j.sorted_norms, j.lists, jnp.asarray(q), probe_ids, jflt, 10, jmetric,
            j.window, M, chunk, jnp.float32, None, n_tiles, j.q_scale)
        td, ti = ivf_scan.cluster_major_scan_tiled(
            t.sorted_data, t.sorted_norms, t.lists, qt, pt, tflt, 10, tmetric, t.window, M, chunk,
            torch.float32, None, n_tiles, t.q_scale)
    else:
        M = int(jax_scan.max_occupancy(probe_ids, 16))
        assert int(ivf_scan.max_occupancy(pt, 16)) == M
        jd, ji = jax_scan.cluster_major_scan(
            j.sorted_data, j.sorted_norms, j.lists, jnp.asarray(q), probe_ids, jflt, 10, jmetric,
            j.window, M, 5, jnp.float32, None, j.q_scale)
        td, ti = ivf_scan.cluster_major_scan(
            t.sorted_data, t.sorted_norms, t.lists, qt, pt, tflt, 10, tmetric, t.window, M, 5,
            torch.float32, None, t.q_scale)
    jd, ji = np.asarray(jd), np.asarray(ji)
    if case == "int8_ip":
        np.testing.assert_array_equal(td.numpy(), jd)
    else:
        np.testing.assert_allclose(td.numpy(), jd, **TOL)
    ids_match_modulo_ties(ti.numpy(), ji, jd, **TOL)
    if filtered:
        assert mask[ti.numpy()[np.isfinite(td.numpy())]].all()


def test_group_pairs_matches_reference_with_drops():
    rng = np.random.default_rng(44)
    probe_ids = rng.integers(0, 6, (40, 3)).astype(np.int32)
    for M in (4, 64):  # 4 slots drop pairs; 64 keep all
        jq, js = jax_scan.group_pairs(jnp.asarray(probe_ids), 6, M)
        tq, ts = ivf_scan.group_pairs(torch.from_numpy(probe_ids), 6, M)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts.numpy() < 64).all() and (np.asarray(
        ivf_scan.group_pairs(torch.from_numpy(probe_ids), 6, 4)[1]) == 4).any()


@pytest.fixture(scope="module")
def pq_indexes(data):
    x, _ = data
    return {cg: jax_pq.build(x, n_lists=16, pq_dim=10, pq_bits=6, seed=0, codebook_gen=cg)
            for cg in ("per_subspace", "per_cluster")}


@pytest.mark.parametrize("bin_cap", [0, 2])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("codebook_gen", ["per_subspace", "per_cluster"])
def test_pq_scan_matches_reference(data, pq_indexes, codebook_gen, metric, bin_cap):
    _, q = data
    j = pq_indexes[codebook_gen].replace(metric=jax_pq.normalize_metric(metric))
    t = _pq_carried(j)
    probe_ids = jax_ivf_common.coarse_search(jnp.asarray(q), j.centers, j.center_norms, 5,
                                             j.metric)
    M = -(-int(jax_scan.max_occupancy(probe_ids, 16)) // 8) * 8
    jd, ji = jax_scan.cluster_major_scan_pq(
        j.sorted_codes, j.centers, j.centers_rot, j.pq_centers, j.rotation, j.lists,
        jnp.asarray(q), probe_ids, jax_filters.no_filter(), 10, j.metric, j.window, M, 3,
        jnp.float32, None, j.pq_bits, j.codebook_gen, j.pq_dim_static, bin_cap)
    td, ti = ivf_scan.cluster_major_scan_pq(
        t.sorted_codes, t.centers, t.centers_rot, t.pq_centers, t.rotation, t.lists,
        torch.from_numpy(q), torch.from_numpy(np.array(probe_ids)), filters.no_filter(), 10,
        t.metric, t.window, M, 3, torch.float32, None, t.pq_bits, t.codebook_gen, t.pq_dim,
        bin_cap)
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(td.numpy(), jd, **TOL)
    ids_match_modulo_ties(ti.numpy(), ji, jd, **TOL)


@pytest.mark.parametrize("codebook_gen", ["per_subspace", "per_cluster"])
def test_pq_search_routes_like_the_reference(data, pq_indexes, codebook_gen):
    """``fused`` without the fused scan (per-cluster codebooks) and big-batch
    ``auto`` on the CPU both run cluster_major, as the reference's search."""
    _, q = data
    j = pq_indexes[codebook_gen]
    t = _pq_carried(j)
    jd, ji = jax_pq.search(j, q, 10, n_probes=5, scan_algo="cluster_major")
    for algo in ("cluster_major", "auto") + (("fused",) if codebook_gen == "per_cluster" else ()):
        td, ti = ivf_pq.search(t, torch.from_numpy(q), 10, n_probes=5, scan_algo=algo)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), **TOL)


def test_auto_routing_on_cpu(data, flat_indexes):
    """tests/test_ivf_scan.py::test_auto_picks_cluster_major_for_big_batches:
    on the CPU a big batch (nq * n_probes >= 4 * n_lists) runs cluster_major,
    a small one query_major; a UDF or cosine under ``fused`` runs
    cluster_major."""
    _, q = data
    t = _flat_carried(flat_indexes["l2"])
    qt = torch.from_numpy(q)
    for nq, probes, algo in ((48, 8, "cluster_major"), (2, 2, "query_major")):
        a = ivf_flat.search(t, qt[:nq], 5, n_probes=probes)
        b = ivf_flat.search(t, qt[:nq], 5, n_probes=probes, scan_algo=algo)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = _flat_carried(flat_indexes["cosine"])
    a = ivf_flat.search(c, qt, 5, n_probes=8, scan_algo="fused")
    b = ivf_flat.search(c, qt, 5, n_probes=8, scan_algo="cluster_major")
    assert torch.equal(a[1], b[1])
    a = ivf_flat.search(t, qt, 5, ivf_flat.SearchParams(n_probes=8, metric_udf=_sq_l2))
    b = ivf_flat.search(t, qt, 5, ivf_flat.SearchParams(n_probes=8, metric_udf=_sq_l2,
                                                        scan_algo="cluster_major"))
    assert torch.equal(a[1], b[1])
    jd, ji = jax_flat.search(flat_indexes["l2"], q, 5,
                             jax_flat.SearchParams(n_probes=8, metric_udf=_sq_l2))
    np.testing.assert_allclose(a[0].numpy(), np.asarray(jd), rtol=1e-5, atol=1e-3)


def test_udf_chunks_bound_the_broadcast_blocks(data, flat_indexes, monkeypatch):
    """A metric UDF may broadcast to [.., d]: the tiled scan sizes its chunk
    of tiles by M * W * d and the coarse search its chunk of queries by
    n_lists * d. With both budgets shrunk to a few chunks the result is
    unchanged."""
    from cuvs_tpu_torch.neighbors import ivf_common

    _, q = data
    t = _flat_carried(flat_indexes["l2"])
    qt = torch.from_numpy(q)
    sp = ivf_flat.SearchParams(n_probes=8, metric_udf=_sq_l2)
    want = ivf_flat.search(t, qt, 5, sp)
    chunks, tiled = [], ivf_scan.cluster_major_scan_tiled
    monkeypatch.setattr(ivf_scan, "cluster_major_scan_tiled",
                        lambda *a: chunks.append(a[10]) or tiled(*a))
    monkeypatch.setattr(ivf_flat, "_CM_BUDGET", 3 * 48 * t.window * t.dim)  # M = 48
    monkeypatch.setattr(ivf_common, "_UDF_BLOCK", 5 * t.n_lists * t.dim)
    got = ivf_flat.search(t, qt, 5, sp)
    assert chunks == [3]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)
    assert torch.equal(got[1], want[1])


def test_overflow_drop_is_bounded():
    """tests/test_ivf_scan.py::test_overflow_drop_is_bounded: 256 identical
    queries all probe the same lists; the nearest list still serves them."""
    x = make_blobs(np.random.default_rng(45), 2000, 8)
    idx = ivf_flat.build(torch.from_numpy(x), n_lists=8, seed=0)
    q = torch.from_numpy(np.tile(x[42][None], (256, 1)))
    _, i = ivf_flat.search(idx, q, 1, n_probes=4, scan_algo="cluster_major")
    assert (i.numpy()[:, 0] == 42).mean() >= 0.9
