"""IVF-Flat: the port against the JAX package on one JAX-built index carried
across (``cuvs_tpu_torch.interop``), and the port's own build, on the CPU.

The reference's fused search runs its Pallas scan in interpret mode off the
TPU; the port's runs the scan kernel's plain version. Tolerances: float32
distances rtol 1e-5 / atol 1e-4 (int8 too: its pools are identical, the
query-norm term added last is a float sum); bf16 storage is rounded
identically on both sides (rtol 1e-3); ids equal except where
distances tie within the tolerance. The port's build uses its own RNG, so it
is held to recall and list balance, not to the reference's ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import ivf_flat as jax_ivf
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import ivf_flat
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)


def _carried(j):
    return interop.ivf_flat_index_from_numpy(
        j.centers, j.center_norms, j.sorted_data, j.sorted_norms, j.lists.offsets,
        j.lists.sizes, j.lists.ids, j.lists.labels, j.q_scale, j.metric, j.window, j.n_rows)


_STORAGE = {"f32": (None, None, jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-4)),
            "bf16": (jnp.bfloat16, torch.bfloat16, jnp.bfloat16, torch.bfloat16,
                     dict(rtol=1e-3, atol=1e-3)),
            # int8 pools are identical; the final |q|^2 term is a float sum
            "int8": (jnp.int8, torch.int8, jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-4))}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return make_blobs(rng, 3000, 40), make_blobs(rng, 32, 40)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_fused_search_on_carried_index_matches_reference(data, storage, metric):
    x, q = data
    jstore, _, jcd, tcd, tol = _STORAGE[storage]
    jidx = jax_ivf.build(x, n_lists=16, metric=metric, seed=0, storage_dtype=jstore)
    tidx = _carried(jidx)
    assert tidx.sorted_data.shape == jidx.sorted_data.shape  # lane-padded dp kept
    jd, ji = jax_ivf.search(jidx, q, 10, jax_ivf.SearchParams(
        n_probes=4, scan_algo="fused", compute_dtype=jcd))
    td, ti = ivf_flat.search(tidx, torch.from_numpy(q), 10, ivf_flat.SearchParams(
        n_probes=4, scan_algo="fused", compute_dtype=tcd))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **tol)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), **tol)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine"])
def test_query_major_search_on_carried_index_matches_reference(data, metric):
    x, q = data
    jidx = jax_ivf.build(x, n_lists=16, metric=metric, seed=0)
    jd, ji = jax_ivf.search(jidx, q, 10, jax_ivf.SearchParams(n_probes=5,
                                                              scan_algo="query_major"))
    td, ti = ivf_flat.search(_carried(jidx), torch.from_numpy(q), 10,
                             ivf_flat.SearchParams(n_probes=5, scan_algo="query_major"))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)


def test_bitset_filtered_fused_search_matches_reference(data):
    from cuvs_tpu.neighbors import filters as jax_filters
    from cuvs_tpu_torch.neighbors import filters

    x, q = data
    mask = np.random.default_rng(12).random(x.shape[0]) < 0.5
    jidx = jax_ivf.build(x, n_lists=16, seed=0)
    jd, ji = jax_ivf.search(jidx, q, 10, jax_ivf.SearchParams(n_probes=4, scan_algo="fused"),
                            prefilter=jax_filters.from_mask(mask))
    td, ti = ivf_flat.search(_carried(jidx), torch.from_numpy(q), 10,
                             ivf_flat.SearchParams(n_probes=4, scan_algo="fused"),
                             prefilter=filters.from_mask(torch.from_numpy(mask)))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)
    assert mask[ti.numpy()[np.isfinite(td.numpy())]].all()


@pytest.mark.parametrize("storage", [None, torch.bfloat16, torch.int8])
def test_own_build_recall_and_balance(storage):
    rng = np.random.default_rng(13)
    x = make_blobs(rng, 4000, 32, n_centers=40)
    q = make_blobs(rng, 50, 32, n_centers=40)
    idx = ivf_flat.build(torch.from_numpy(x), n_lists=32, seed=0, storage_dtype=storage)
    sizes = idx.lists.sizes.numpy()
    assert sizes.sum() == 4000 and idx.n_rows == 4000
    assert sizes.max() <= 3 * sizes.mean()  # balanced lists bound the scan window
    assert idx.window == -(-sizes.max() // 128) * 128
    gtd, gti = naive_knn(q, x, 10)
    for algo in ("fused", "query_major"):
        d, i = ivf_flat.search(idx, torch.from_numpy(q), 10,
                               ivf_flat.SearchParams(n_probes=12, scan_algo=algo))
        assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.9


def test_auto_picks_query_major_on_cpu_and_rejects_unported_algos(data):
    x, q = data
    idx = ivf_flat.build(torch.from_numpy(x), n_lists=8, seed=0)
    qt = torch.from_numpy(q)
    a = ivf_flat.search(idx, qt, 5, n_probes=8)
    b = ivf_flat.search(idx, qt, 5, n_probes=8, scan_algo="query_major")
    assert torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        ivf_flat.search(idx, qt, 5, scan_algo="cluster_major")


def _sq_l2(x, y):  # a metric UDF written once for both frameworks
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def test_metric_udf_search_matches_reference(data):
    x, q = data
    jidx = jax_ivf.build(x, n_lists=16, seed=0)
    jd, ji = jax_ivf.search(jidx, q[:8], 5, jax_ivf.SearchParams(n_probes=3, metric_udf=_sq_l2))
    td, ti = ivf_flat.search(_carried(jidx), torch.from_numpy(q[:8]), 5,
                             ivf_flat.SearchParams(n_probes=3, metric_udf=_sq_l2))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-3)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-3)
