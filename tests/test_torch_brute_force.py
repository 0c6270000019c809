"""Brute force and refine: the port against the JAX package on one index
carried across (``cuvs_tpu_torch.interop``), on the CPU.

Tolerances: float32 distances rtol 1e-5 / atol 1e-4 (same math, another
summation order); int8 index contents and int8 distances are identical; ids
equal except where distances tie within the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import brute_force as jax_bf
from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu.neighbors import refine as jax_refine
from cuvs_tpu.ops import bf_topk_pallas
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import brute_force, filters, refine
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)


def _carried(jidx):
    return interop.brute_force_index_from_numpy(
        np.asarray(jidx.dataset), None if jidx.norms is None else np.asarray(jidx.norms),
        None if jidx.q_scale is None else np.asarray(jidx.q_scale), jidx.metric,
        device="cpu")


@pytest.mark.parametrize("storage", [None, "int8"])
def test_build_matches_reference(storage):
    rng = np.random.default_rng(1)
    x = make_blobs(rng, 2000, 24)
    j = jax_bf.build(x, storage_dtype=jnp.int8 if storage else None)
    t = brute_force.build(torch.from_numpy(x), storage_dtype=torch.int8 if storage else None)
    np.testing.assert_allclose(t.norms.numpy(), np.asarray(j.norms), rtol=1e-6)
    if storage:
        assert t.dataset.dtype == torch.int8
        assert float(t.q_scale) == float(j.q_scale)
        assert np.array_equal(t.dataset.numpy(), np.asarray(j.dataset))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine"])
@pytest.mark.parametrize("tile_size", [None, 700])  # one block / a merge over tiles
def test_unfused_search_matches_reference(metric, tile_size):
    rng = np.random.default_rng(2)
    x = make_blobs(rng, 3000, 32)
    q = make_blobs(rng, 40, 32)
    jidx = jax_bf.build(x, metric=metric)
    jd, ji = jax_bf.search(jidx, q, 10, tile_size=tile_size)
    td, ti = brute_force.search(_carried(jidx), torch.from_numpy(q), 10, tile_size=tile_size)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd))


@pytest.mark.parametrize("kind", ["bitset", "bitmap"])
def test_filtered_search_matches_reference(kind):
    rng = np.random.default_rng(3)
    x = make_blobs(rng, 1000, 16)
    q = make_blobs(rng, 12, 16)
    mask = rng.random(1000 if kind == "bitset" else (12, 1000)) < 0.3
    jidx = jax_bf.build(x)
    jd, ji = jax_bf.search(jidx, q, 5, prefilter=jax_filters.from_mask(mask), tile_size=300)
    td, ti = brute_force.search(_carried(jidx), torch.from_numpy(q), 5,
                                prefilter=filters.from_mask(torch.from_numpy(mask)),
                                tile_size=300)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd))
    rows = np.arange(12)[:, None]
    allowed = mask[ti.numpy()] if kind == "bitset" else mask[rows, ti.numpy()]
    assert allowed.all()


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_fused_exact_matches_reference(metric):
    # the reference's fused=True runs its exact unfused path off the TPU; the
    # port's runs the exact kernel's plain version: both are exact
    rng = np.random.default_rng(4)
    x = make_blobs(rng, 2500, 32)
    q = make_blobs(rng, 30, 32)
    jidx = jax_bf.build(x, metric=metric)
    jd, ji = jax_bf.search(jidx, q, 16, fused=True)
    td, ti = brute_force.search(_carried(jidx), torch.from_numpy(q), 16, fused=True)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd))


def test_int8_fused_and_refine_match_reference():
    rng = np.random.default_rng(5)
    x = make_blobs(rng, 6000, 32)
    q = make_blobs(rng, 24, 32)
    jidx = jax_bf.build(x, storage_dtype=jnp.int8)
    tidx = _carried(jidx)
    # the reference's kernel in interpret mode (its public fused=True does
    # not reach the kernel off the TPU)
    jd, ji = bf_topk_pallas.search(jidx.dataset, jidx.norms, q, 40, exact=False,
                                   q_scale=jidx.q_scale, interpret=True)
    td, ti = brute_force.search(tidx, torch.from_numpy(q), 40, recall_target=0.97, fused=True)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 0.0, 0.0)
    rd, ri = jax_refine.refine(x, q, ji, 10)
    sd, si = refine.refine(torch.from_numpy(x), torch.from_numpy(q),
                           torch.from_numpy(np.array(ji)), 10)
    np.testing.assert_allclose(sd.numpy(), np.asarray(rd), **TOL)
    ids_match_modulo_ties(si.numpy(), np.asarray(ri), np.asarray(rd))
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(si.numpy(), gti, sd.numpy(), gtd) >= 0.9


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine"])
def test_refine_matches_reference_with_invalid_slots(metric):
    rng = np.random.default_rng(6)
    x = make_blobs(rng, 500, 16)
    q = make_blobs(rng, 10, 16)
    cand = rng.integers(0, 500, (10, 20)).astype(np.int32)
    cand[:, 3] = -1  # invalid slots
    cand[0, :] = -1  # a query with no valid candidate: id 0, distance +-inf
    cand[0, 0] = 7
    jd, ji = jax_refine.refine(x, q, cand, 5, metric=metric)
    td, ti = refine.refine(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(cand), 5,
                           metric=metric)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert np.array_equal(ti.numpy()[0], np.asarray(ji)[0])  # [7, 0, 0, 0, 0]
    ids_match_modulo_ties(ti.numpy()[1:], np.asarray(ji)[1:], np.asarray(jd)[1:])
    assert ti.dtype == torch.int32


def test_metric_udf_matches_reference():
    rng = np.random.default_rng(7)
    x = make_blobs(rng, 800, 8)
    q = make_blobs(rng, 6, 8)

    def l1(a, b):  # a metric UDF written once for both frameworks
        return abs(a[:, None, :] - b[None, :, :]).sum(-1)

    jidx = jax_bf.build(x, metric=l1)
    jd, ji = jax_bf.search(jidx, q, 4, tile_size=300)
    td, ti = brute_force.search(_carried(jidx), torch.from_numpy(q), 4, tile_size=300)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd))


_LONG_TAIL = ["l1", "chebyshev", "canberra", "minkowski", "hamming", "braycurtis",
              "jensenshannon", "kl_divergence", "L2Unexpanded", "L2SqrtUnexpanded",
              "haversine", "bitwise_hamming"]


def _long_tail_data(metric, rng):
    if metric == "bitwise_hamming":
        return (rng.integers(0, 256, (600, 8)).astype(np.uint8),
                rng.integers(0, 256, (12, 8)).astype(np.uint8))
    if metric == "haversine":
        scale = np.array([np.pi, 2 * np.pi], np.float32)
        return ((rng.random((600, 2), np.float32) - 0.5) * scale,
                (rng.random((12, 2), np.float32) - 0.5) * scale)
    if metric == "hamming":
        return ((rng.random((600, 16)) > 0.5).astype(np.float32),
                (rng.random((12, 16)) > 0.5).astype(np.float32))
    x, q = rng.random((600, 16), np.float32) + 0.01, rng.random((12, 16), np.float32) + 0.01
    return x / x.sum(1, keepdims=True), q / q.sum(1, keepdims=True)


@pytest.mark.parametrize("metric", _LONG_TAIL)
@pytest.mark.parametrize("tile_size", [None, 250])  # one block / a merge over tiles
def test_long_tail_search_matches_reference(metric, tile_size):
    rng = np.random.default_rng(8)
    x, q = _long_tail_data(metric, rng)
    jidx = jax_bf.build(x, metric=metric, metric_arg=3.0)
    jd, ji = jax_bf.search(jidx, q, 7, tile_size=tile_size)
    tidx = brute_force.build(torch.from_numpy(x), metric=metric, metric_arg=3.0)
    td, ti = brute_force.search(tidx, torch.from_numpy(q), 7, tile_size=tile_size)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-5)


@pytest.mark.parametrize("metric", ["correlation", "hellinger", "russellrao", "jaccard", "dice"])
def test_other_expanded_metrics_rank_by_pairwise_distance(metric):
    # the reference's brute force raises on these (its pointwise block has no
    # case for them); the port ranks them by pairwise_distance
    from cuvs_tpu_torch.distance.pairwise import pairwise_distance

    rng = np.random.default_rng(9)
    x, q = rng.random((500, 12), np.float32), rng.random((9, 12), np.float32)
    td, ti = brute_force.search(brute_force.build(torch.from_numpy(x), metric=metric),
                                torch.from_numpy(q), 6, tile_size=200)
    full = pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), metric=metric).numpy()
    order = np.argsort(full, axis=1, kind="stable")[:, :6]
    np.testing.assert_allclose(td.numpy(), np.take_along_axis(full, order, 1), rtol=1e-6)
    ids_match_modulo_ties(ti.numpy(), order, np.take_along_axis(full, order, 1))
