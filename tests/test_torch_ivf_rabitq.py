"""IVF-RaBitQ: the port against the JAX package on JAX-built indexes carried
across (``cuvs_tpu_torch.interop``), its encoding on the reference's rotation
and centers, and the port's own build, on the CPU.

The reference's fused search runs its Pallas scan in interpret mode off the
TPU; the port's runs the quantized-code scan kernel's plain version.
Tolerances: distances rtol 1e-5 / atol 1e-4 (bf16 products summed in f32 in
another order; the per-probe cluster terms are f32 sums in another order),
ids equal except where distances tie within the tolerance. The scaling
factor is the same numpy code and must be equal. Levels and factors start
from residuals that are f32 matrix products summed in another order, so a
level may fall on the other side of a grid step: at most 0.1% of levels
differ, and the factors of the rows whose levels agree match at rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.core import bitpack as jax_bitpack
from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu.neighbors import ivf_rabitq as jax_rq
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import filters, ivf_rabitq, refine
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)


def _carried(j):
    return interop.ivf_rabitq_index_from_numpy(
        j.centers, j.center_norms, j.rotation, j.centers_rot, j.sorted_codes, j.sorted_fadd,
        j.sorted_frescale, j.lists.offsets, j.lists.sizes, j.lists.ids, j.lists.labels, j.metric,
        j.window, j.n_rows, j.bits_per_dim, j.sorted_codes_t, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    return make_blobs(rng, 2000, 32, n_centers=30), make_blobs(rng, 24, 32, n_centers=30)


@pytest.fixture(scope="module")
def built(data):
    """The reference's index per bit width. The codes do not depend on the
    metric, which only picks the search's final transform (``_index``)."""
    return {bits: jax_rq.build(data[0], n_lists=16, bits_per_dim=bits, seed=0)
            for bits in (1, 3, 8, 9)}


def _index(built, bits, metric):
    return built[bits].replace(metric=jax_rq.normalize_metric(metric))


def _both(data, built, bits, metric, jsp, tsp, jflt=None, tflt=None):
    _, q = data
    jidx = _index(built, bits, metric)
    jd, ji = jax_rq.search(jidx, q, 10, jsp, prefilter=jflt)
    td, ti = ivf_rabitq.search(_carried(jidx), torch.from_numpy(q), 10, tsp, prefilter=tflt)
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


@pytest.mark.parametrize("dim,ex_bits", [(32, 0), (32, 2), (128, 2), (100, 7), (64, 8)])
def test_best_scaling_factor_matches_reference(dim, ex_bits):
    assert ivf_rabitq.best_scaling_factor(dim, ex_bits) == jax_rq.best_scaling_factor(dim, ex_bits)


@pytest.mark.parametrize("bits", [1, 3, 8, 9])
def test_encoding_on_reference_rotation_and_centers_matches_reference(data, built, bits):
    x, _ = data
    j = built[bits]
    n = j.n_rows
    ids = np.asarray(j.lists.ids)[:n]
    labels = np.empty(n, np.int64)
    labels[ids] = np.asarray(j.lists.labels)[:n]  # each row's list, in row order
    lv, fadd, fres = ivf_rabitq._encode(
        torch.from_numpy(x), torch.from_numpy(np.array(j.centers)),
        torch.from_numpy(np.array(j.centers_rot)), torch.from_numpy(labels),
        torch.from_numpy(np.array(j.rotation)), bits)
    ref_lv = np.asarray(jax_bitpack.unpack(j.sorted_codes[:n], bits, x.shape[1]))
    got_lv = lv.numpy()[ids]
    assert np.mean(got_lv != ref_lv) <= 1e-3
    same = (got_lv == ref_lv).all(1)
    assert same.mean() > 0.9
    np.testing.assert_allclose(fadd.numpy()[ids][same], np.asarray(j.sorted_fadd)[:n][same],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fres.numpy()[ids][same], np.asarray(j.sorted_frescale)[:n][same],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_fused_search_on_carried_index_matches_reference(data, built, bits, metric):
    jd, ji, td, ti = _both(data, built, bits, metric,
                           jax_rq.SearchParams(n_probes=4, scan_algo="fused"),
                           ivf_rabitq.SearchParams(n_probes=4, scan_algo="fused"))
    np.testing.assert_allclose(td, jd, **TOL)
    ids_match_modulo_ties(ti, ji, jd, **TOL)


@pytest.mark.parametrize("bits", [1, 3, 8, 9])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
def test_query_major_search_on_carried_index_matches_reference(data, built, bits, metric):
    jd, ji, td, ti = _both(data, built, bits, metric,
                           jax_rq.SearchParams(n_probes=5, scan_algo="query_major"),
                           ivf_rabitq.SearchParams(n_probes=5, scan_algo="query_major"))
    np.testing.assert_allclose(td, jd, **TOL)
    ids_match_modulo_ties(ti, ji, jd, **TOL)


def test_nine_bits_have_no_fused_layout_and_search_query_major(data, built):
    j = _carried(built[9])
    assert j.sorted_codes_t is None
    _, q = data
    a = ivf_rabitq.search(j, torch.from_numpy(q), 5, n_probes=4, scan_algo="fused")
    b = ivf_rabitq.search(j, torch.from_numpy(q), 5, n_probes=4, scan_algo="query_major")
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("kind", ["bitset", "bitmap"])
@pytest.mark.parametrize("algo", ["fused", "query_major"])
def test_filtered_search_on_carried_index_matches_reference(data, built, kind, algo):
    x, q = data
    rng = np.random.default_rng(24)
    shape = (x.shape[0],) if kind == "bitset" else (q.shape[0], x.shape[0])
    mask = rng.random(shape) < 0.5
    jd, ji, td, ti = _both(data, built, 3, "sqeuclidean",
                           jax_rq.SearchParams(n_probes=4, scan_algo=algo),
                           ivf_rabitq.SearchParams(n_probes=4, scan_algo=algo),
                           jax_filters.from_mask(mask), filters.from_mask(torch.from_numpy(mask)))
    np.testing.assert_allclose(td, jd, **TOL)
    ids_match_modulo_ties(ti, ji, jd, **TOL)
    ok = np.isfinite(td)
    if kind == "bitset":
        assert mask[ti[ok]].all()
    else:
        assert mask[np.nonzero(ok)[0], ti[ok]].all()


def test_bitset_filter_leaves_the_index_factors_untouched(data, built):
    x, q = data
    tidx = _carried(built[3])
    before = tidx.sorted_fadd.clone()
    mask = np.random.default_rng(25).random(x.shape[0]) < 0.5
    ivf_rabitq.search(tidx, torch.from_numpy(q), 10,
                      ivf_rabitq.SearchParams(n_probes=4, scan_algo="fused"),
                      prefilter=filters.from_mask(torch.from_numpy(mask)))
    assert torch.equal(tidx.sorted_fadd, before)


def test_own_build_recall_with_refine():
    """tests/test_ivf_rabitq.py::test_recall_with_refine's configuration and
    floor, on both scans, on 10000 of its 20000 rows."""
    rng = np.random.default_rng(131)
    x = make_blobs(rng, 10000, 64, n_centers=100)
    q = make_blobs(rng, 100, 64, n_centers=100)
    idx = ivf_rabitq.build(torch.from_numpy(x), n_lists=64, bits_per_dim=3, seed=0)
    # 64 dims x 3 bits = 6 words, no pad of the word rows
    assert idx.sorted_codes_t.shape == (6, idx.n_rows + idx.window)
    _, gti = naive_knn(q, x, 10)
    for algo in ("query_major", "fused"):
        _, cand = ivf_rabitq.search(idx, torch.from_numpy(q), 40, n_probes=32, scan_algo=algo)
        _, ri = refine.refine(torch.from_numpy(x), torch.from_numpy(q), cand, 10)
        assert calc_recall(ri.numpy(), gti) >= 0.9, algo


def test_auto_picks_query_major_on_cpu_and_rejects_unported_algos(data, built):
    j = _carried(built[3])
    _, q = data
    a = ivf_rabitq.search(j, torch.from_numpy(q), 5, n_probes=16)
    b = ivf_rabitq.search(j, torch.from_numpy(q), 5, n_probes=16, scan_algo="query_major")
    assert torch.equal(a[1], b[1])
    # the reference runs the query-major scan for cluster_major (it has no
    # unfused cluster-major RaBitQ scan); an unknown name is rejected
    c = ivf_rabitq.search(j, torch.from_numpy(q), 5, n_probes=16, scan_algo="cluster_major")
    assert torch.equal(c[0], b[0]) and torch.equal(c[1], b[1])
    with pytest.raises(ValueError):
        ivf_rabitq.search(j, torch.from_numpy(q), 5, scan_algo="bogus")
