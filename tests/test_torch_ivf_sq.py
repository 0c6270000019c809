"""The quantizers (``preprocessing.quantize``) and IVF-SQ in the port against
the JAX package, on the CPU.

Exact: the scalar transform and its inverse given the same quantizer, the
binary codes for the ``zero`` and ``mean`` thresholds, the PQ codes and
their decoding given the same codebooks. ``scalar_train`` interpolates its
quantile positions in float64 where the reference uses float32, so the two
ranges agree to rtol 1e-5. Randomly drawn parts (the sampled median, the PQ
codebooks' initial rows) are held to the reference tests' error bounds.
IVF-SQ searches on a carried index: distances rtol 1e-5 / atol 1e-4, ids
equal except at ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu.neighbors import ivf_sq as jax_sq
from cuvs_tpu.preprocessing import quantize as jax_q
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import filters, ivf_sq
from cuvs_tpu_torch.preprocessing import quantize
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def x():
    return make_blobs(np.random.default_rng(61), 2000, 20)


def test_scalar_quantizer_matches_reference(x):
    jq = jax_q.scalar_train(x)
    tq = quantize.scalar_train(x, device="cpu")
    np.testing.assert_allclose([float(tq.min_), float(tq.max_)],
                               [float(jq.min_), float(jq.max_)], rtol=1e-5)
    carried = quantize.ScalarQuantizer(min_=torch.tensor(float(jq.min_)),
                                       max_=torch.tensor(float(jq.max_)))
    codes = quantize.scalar_transform(carried, x)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jax_q.scalar_transform(jq, x)))
    np.testing.assert_array_equal(quantize.scalar_inverse_transform(carried, codes).numpy(),
                                  np.asarray(jax_q.scalar_inverse_transform(jq, codes.numpy())))
    # tests/test_preprocessing.py::test_scalar_roundtrip's bound
    back = quantize.scalar_inverse_transform(tq, quantize.scalar_transform(tq, x)).numpy()
    inside = (x >= float(tq.min_)) & (x <= float(tq.max_))
    assert np.abs(back - x)[inside].max() <= float(tq.max_ - tq.min_) / 255.0 * 1.01


def test_scalar_train_above_the_torch_quantile_limit():
    """2^24 + 128 values: torch.quantile refuses them; the order statistics
    must equal numpy's linear quantile."""
    v = np.random.default_rng(62).standard_normal((131073, 128)).astype(np.float32)
    assert v.size > 1 << 24
    tq = quantize.scalar_train(v, device="cpu")
    flat = np.sort(v.reshape(-1)).astype(np.float64)
    for q, got in ((0.005, tq.min_), (0.995, tq.max_)):
        pos = q * (flat.size - 1)
        lo = int(np.floor(pos))
        want = flat[lo] + (flat[lo + 1] - flat[lo]) * (pos - lo)
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("threshold", ["zero", "mean"])
def test_binary_codes_match_reference(x, threshold):
    got = quantize.binary_transform(quantize.binary_train(x, threshold, device="cpu"), x)
    want = np.asarray(jax_q.binary_transform(jax_q.binary_train(x, threshold), x))
    assert got.dtype == torch.uint8 and got.shape == (2000, 3)  # ceil(20/8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_binary_sampling_median_and_bit_layout(x):
    """tests/test_preprocessing.py::test_binary_thresholds."""
    q = quantize.binary_train(x, "sampling_median", device="cpu")
    assert quantize.binary_transform(q, x).shape == (2000, 3)
    # the threshold is a median of its sample: about half the rows lie above it
    frac = (x > q.threshold.numpy()[None]).mean(0)
    assert np.all(np.abs(frac - 0.5) < 0.1)
    pos = np.abs(x) + 1.0
    codes = quantize.binary_transform(quantize.binary_train(pos, "zero", device="cpu"), pos)
    assert (codes[:, 0] == 0xFF).all() and (codes[:, 2] == 0x0F).all()


def test_pq_quantizer(x):
    """tests/test_preprocessing.py::test_pq_roundtrip_error and
    test_vpq_roundtrip's bounds; codes and decoding of the reference's
    codebooks identical."""
    xs = make_blobs(np.random.default_rng(63), 3000, 32)
    q = quantize.pq_train(xs, pq_dim=16, device="cpu")
    codes = quantize.pq_transform(q, xs)
    assert codes.shape == (3000, 16) and codes.dtype == torch.uint8
    back = quantize.pq_inverse_transform(q, codes).numpy()
    assert np.linalg.norm(back - xs) / np.linalg.norm(xs) < 0.15
    jq = jax_q.pq_train(x, pq_dim=7, pq_bits=5, n_iters=5)  # 20 dims: a padded last subspace
    carried = quantize.PQQuantizer(codebooks=torch.from_numpy(np.array(jq.codebooks)), dim=20)
    tc = quantize.pq_transform(carried, x)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jax_q.pq_transform(jq, x)))
    np.testing.assert_array_equal(quantize.pq_inverse_transform(carried, tc).numpy(),
                                  np.asarray(jax_q.pq_inverse_transform(jq, tc.numpy())))
    v = quantize.vpq_train(xs, vq_n_centers=64, pq_dim=16, device="cpu")
    vq_codes, pq_codes = quantize.vpq_encode(v, xs)
    assert pq_codes.shape == (3000, 16) and vq_codes.dtype == torch.int32
    back = quantize.vpq_decode(v, vq_codes, pq_codes).numpy()
    assert np.linalg.norm(back - xs) / np.linalg.norm(xs) < 0.12


@pytest.fixture(scope="module")
def sq_data():
    rng = np.random.default_rng(64)
    return make_blobs(rng, 4000, 32, n_centers=40), make_blobs(rng, 40, 32, n_centers=40)


def _carried(j):
    return interop.ivf_sq_index_from_numpy(
        j.centers, j.center_norms, j.sorted_codes, j.sorted_norms, j.q_min, j.q_max,
        j.lists.offsets, j.lists.sizes, j.lists.ids, j.lists.labels, j.metric, j.window, j.n_rows,
        device="cpu")


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_search_on_carried_index_matches_reference(sq_data, metric, compute):
    x, q = sq_data
    jcd, tcd = (jnp.float32, torch.float32) if compute == "f32" else (jnp.bfloat16,
                                                                     torch.bfloat16)
    j = jax_sq.build(x, n_lists=16, metric=metric, seed=0)
    mask = np.random.default_rng(65).random(x.shape[0]) < 0.7
    jd, ji = jax_sq.search(j, q, 10, jax_sq.SearchParams(n_probes=5, compute_dtype=jcd),
                           prefilter=jax_filters.from_mask(mask))
    t = _carried(j)
    td, ti = ivf_sq.search(t, torch.from_numpy(q), 10,
                           ivf_sq.SearchParams(n_probes=5, compute_dtype=tcd),
                           prefilter=filters.from_mask(torch.from_numpy(mask)))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)
    assert mask[ti.numpy()[np.isfinite(td.numpy())]].all()


def test_query_chunks_match_one_chunk(sq_data, monkeypatch):
    x, q = sq_data
    t = _carried(jax_sq.build(x, n_lists=16, seed=0))
    a = ivf_sq.search(t, torch.from_numpy(q), 10, n_probes=6)
    monkeypatch.setattr(ivf_sq, "_SCAN_BLOCK", t.window * 32 * 7)  # 7-query chunks
    b = ivf_sq.search(t, torch.from_numpy(q), 10, n_probes=6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_own_build_matches_reference_quantizer_and_recall(sq_data):
    """tests/test_ivf_sq.py::test_recall and test_full_probe_near_exact's
    floors on the port's own build."""
    x, q = sq_data
    j = jax_sq.build(x, n_lists=16, seed=0)
    t = ivf_sq.build(x, n_lists=16, seed=0, device="cpu")
    assert t.sorted_codes.dtype == torch.int8 and t.n_rows == 4000
    np.testing.assert_allclose([float(t.q_min), float(t.q_max)],
                               [float(j.q_min), float(j.q_max)], rtol=1e-5)
    gtd, gti = naive_knn(q, x, 10)
    d, i = ivf_sq.search(t, torch.from_numpy(q), 10, n_probes=8)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.85
    d, i = ivf_sq.search(t, torch.from_numpy(q), 10, n_probes=16)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.95
    np.testing.assert_allclose(d.numpy(), gtd, rtol=0.1, atol=0.5)
