"""IVF-PQ: the port against the JAX package on one JAX-built index carried
across (``cuvs_tpu_torch.interop``), its build steps on the same inputs, and
the port's own build, on the CPU.

The reference's fused search runs its Pallas scan in interpret mode off the
TPU; the port's runs the quantized-code scan kernel's plain version.
Tolerances: distances rtol 1e-5 / atol 1e-4 (the pools agree to that; the
per-probe cluster terms are f32 sums in another order), ids equal except
where distances tie within the tolerance. Codes from the same residuals and
codebooks are integer results of the same roundings and must be identical;
codebooks trained from the same initial rows agree to rtol 1e-5. The port's
own build uses its own RNG, so it is held to the reference tests' recall
floors, not to the reference's ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu.neighbors import ivf_pq as jax_pq
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import filters, ivf_pq, refine
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)


def _carried(j):
    return interop.ivf_pq_index_from_numpy(
        j.centers, j.center_norms, j.centers_rot, j.rotation, j.pq_centers, j.sorted_codes,
        j.lists.offsets, j.lists.sizes, j.lists.ids, j.lists.labels, j.metric, j.window,
        j.n_rows, j.pq_bits, j.sorted_codes_t, j.sorted_code_norms, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    return make_blobs(rng, 3000, 32, n_centers=30), make_blobs(rng, 32, 32, n_centers=30)


@pytest.fixture(scope="module")
def indexes(data):
    x, _ = data
    return {m: jax_pq.build(x, n_lists=16, pq_dim=16, metric=m, seed=0)
            for m in ("sqeuclidean", "inner_product")}


def _both(indexes, data, metric, k, jsp, tsp, jflt=None, tflt=None, carried_metric=None):
    _, q = data
    jidx = indexes[metric]
    jd, ji = jax_pq.search(jidx, q, k, jsp, prefilter=jflt)
    tidx = _carried(jidx)
    if carried_metric is not None:  # same codes, another final transform
        jidx = jidx.replace(metric=jax_pq.normalize_metric(carried_metric))
        jd, ji = jax_pq.search(jidx, q, k, jsp, prefilter=jflt)
        tidx.metric = jidx.metric
    td, ti = ivf_pq.search(tidx, torch.from_numpy(q), k, tsp, prefilter=tflt)
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


def test_calculate_pq_dim_matches_reference():
    for dim in (1, 7, 20, 32, 96, 100, 128, 960):
        assert ivf_pq.calculate_pq_dim(dim) == jax_pq.calculate_pq_dim(dim)


def test_carried_index_keeps_the_reference_padded_serving_layout(indexes):
    j = indexes["sqeuclidean"]
    t = _carried(j)
    # 16 codes of 8 bits = 4 word rows; the reference pads them to 8 and pads
    # its norms for a 1024-row window; the port reads both by index
    assert t.sorted_codes_t.shape == np.shape(j.sorted_codes_t) and t.sorted_codes_t.shape[0] == 8
    assert t.sorted_code_norms.shape[0] > j.n_rows + j.window
    assert t.pq_dim == 16 and t.pq_len == 2 and t.pq_book_size == 256


def test_encode_matches_reference():
    rng = np.random.default_rng(3)
    res = rng.standard_normal((700, 32)).astype(np.float32)
    cb = rng.standard_normal((16, 256, 2)).astype(np.float32)
    ref = np.asarray(jax_pq._encode(jnp.asarray(res), jnp.asarray(cb)))
    got = ivf_pq._encode(torch.from_numpy(res), torch.from_numpy(cb))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), ref)


def test_train_codebooks_matches_reference_from_the_same_initial_rows():
    rng = np.random.default_rng(4)
    res = rng.standard_normal((8, 600, 2)).astype(np.float32)  # [pq_dim, n_train, pq_len]
    key, book, n_iters = jax.random.PRNGKey(5), 32, 6
    ref = np.asarray(jax_pq._train_codebooks(key, jnp.asarray(res), book, n_iters))
    # the reference's own draw of initial rows (vmapped choice per subspace)
    init = jax.vmap(lambda k: jax.random.choice(k, res.shape[1], (book,), replace=False))(
        jax.random.split(key, res.shape[0]))
    got = ivf_pq._train_codebooks(torch.from_numpy(res), torch.from_numpy(np.array(init)).long(),
                                  n_iters)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("lut", ["bf16", "int8"])
def test_fused_search_on_carried_index_matches_reference(indexes, data, metric, lut):
    jl, tl = (jnp.int8, torch.int8) if lut == "int8" else (jnp.float32, torch.float32)
    jd, ji, td, ti = _both(indexes, data, metric, 10,
                           jax_pq.SearchParams(n_probes=4, scan_algo="fused", lut_dtype=jl),
                           ivf_pq.SearchParams(n_probes=4, scan_algo="fused", lut_dtype=tl))
    np.testing.assert_allclose(td, jd, **TOL)
    ids_match_modulo_ties(ti, ji, jd, **TOL)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
@pytest.mark.parametrize("lut", ["f32", "bf16", "int8"])
def test_query_major_search_on_carried_index_matches_reference(indexes, data, metric, lut):
    jl, tl = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
              "int8": (jnp.int8, torch.int8)}[lut]
    build_metric = "inner_product" if metric == "inner_product" else "sqeuclidean"
    jd, ji, td, ti = _both(
        indexes, data, build_metric, 10,
        jax_pq.SearchParams(n_probes=5, scan_algo="query_major", lut_dtype=jl),
        ivf_pq.SearchParams(n_probes=5, scan_algo="query_major", lut_dtype=tl),
        carried_metric=metric if metric == "euclidean" else None)
    np.testing.assert_allclose(td, jd, **TOL)
    ids_match_modulo_ties(ti, ji, jd, **TOL)


@pytest.mark.parametrize("kind", ["bitset", "bitmap"])
@pytest.mark.parametrize("algo", ["fused", "query_major"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_filtered_search_on_carried_index_matches_reference(indexes, data, kind, algo, metric):
    x, q = data
    rng = np.random.default_rng(6)
    shape = (x.shape[0],) if kind == "bitset" else (q.shape[0], x.shape[0])
    mask = rng.random(shape) < 0.5
    jflt, tflt = jax_filters.from_mask(mask), filters.from_mask(torch.from_numpy(mask))
    jd, ji, td, ti = _both(indexes, data, metric, 10,
                           jax_pq.SearchParams(n_probes=4, scan_algo=algo),
                           ivf_pq.SearchParams(n_probes=4, scan_algo=algo), jflt, tflt)
    np.testing.assert_allclose(td, jd, **TOL)
    ids_match_modulo_ties(ti, ji, jd, **TOL)
    ok = np.isfinite(td)
    if kind == "bitset":
        assert mask[ti[ok]].all()
    else:
        assert mask[np.nonzero(ok)[0], ti[ok]].all()


def test_bitset_filter_leaves_the_index_norms_untouched(indexes, data):
    x, q = data
    tidx = _carried(indexes["sqeuclidean"])
    before = tidx.sorted_code_norms.clone()
    mask = np.random.default_rng(7).random(x.shape[0]) < 0.5
    ivf_pq.search(tidx, torch.from_numpy(q), 10, ivf_pq.SearchParams(n_probes=4, scan_algo="fused"),
                  prefilter=filters.from_mask(torch.from_numpy(mask)))
    assert torch.equal(tidx.sorted_code_norms, before)


def test_own_build_recall_l2():
    """tests/test_ivf_pq.py::test_recall_l2's configuration and floor, on
    10000 of its 20000 rows, with codebooks trained on 8 rows per code, not
    256, to keep the CPU test short."""
    rng = np.random.default_rng(9)
    x = make_blobs(rng, 10000, 64, n_centers=100)
    q = make_blobs(rng, 100, 64, n_centers=100)
    idx = ivf_pq.build(torch.from_numpy(x), n_lists=64, pq_dim=32, seed=0,
                       max_train_points_per_pq_code=8)
    assert idx.sorted_codes_t.shape == (8, idx.n_rows + idx.window)  # no pad of the word rows
    assert idx.sorted_code_norms.shape == (idx.n_rows + idx.window,)
    _, gti = naive_knn(q, x, 10)
    for algo in ("query_major", "fused"):
        _, i = ivf_pq.search(idx, torch.from_numpy(q), 10, n_probes=32, scan_algo=algo)
        assert calc_recall(i.numpy(), gti) >= 0.65, algo


def test_own_build_fused_refine_min_recall():
    """tests/test_reference_recall.py::test_ivf_pq_fused_refine_min_recall
    (codebooks trained on 16 rows per code, not 256)."""
    rng = np.random.default_rng(42)
    x = (rng.standard_normal((12000, 32)) * 2.0).astype(np.float32)
    q = (rng.standard_normal((100, 32)) * 2.0).astype(np.float32)
    _, gti = naive_knn(q, x, 10)
    idx = ivf_pq.build(torch.from_numpy(x), n_lists=64, pq_dim=16, seed=0,
                       max_train_points_per_pq_code=16)
    _, cand = ivf_pq.search(idx, torch.from_numpy(q), 64,
                            ivf_pq.SearchParams(n_probes=48, scan_algo="fused"))
    _, ri = refine.refine(torch.from_numpy(x), torch.from_numpy(q), cand, 10)
    assert calc_recall(ri.numpy(), gti) >= 0.95


def test_chunked_residuals_match_unchunked(monkeypatch):
    x = make_blobs(np.random.default_rng(8), 2048, 16, n_centers=20)
    monkeypatch.setattr(ivf_pq, "_RES_CHUNK_BYTES", 16 * 4 * 256)  # 256-row chunks
    a = ivf_pq.build(torch.from_numpy(x), n_lists=8, pq_dim=8, pq_bits=5, seed=0)
    monkeypatch.setattr(ivf_pq, "_RES_CHUNK_BYTES", 256 << 20)
    b = ivf_pq.build(torch.from_numpy(x), n_lists=8, pq_dim=8, pq_bits=5, seed=0)
    assert torch.equal(a.sorted_codes, b.sorted_codes)
    # 5-bit codes: packed at 5 bits, served as bytes
    assert a.sorted_codes.shape[1] == 2 and a.sorted_codes_t.shape[0] == 2


def test_unported_parts_raise(data):
    """The parts that raised before they were ported (per-cluster codebooks,
    build_streaming, extend, the cluster-major scan) now run; only an
    unknown scan algorithm is refused, and auto runs query_major for a small
    batch of CPU queries."""
    x, q = data
    pc = ivf_pq.build(torch.from_numpy(x), n_lists=8, pq_dim=8, pq_bits=5, seed=0,
                      codebook_gen="per_cluster")
    assert pc.pq_centers.shape == (8, 32, 4) and pc.sorted_codes_t is None
    st = ivf_pq.build_streaming(lambda i: x[i * 1000:(i + 1) * 1000], 3, n_lists=8, pq_dim=8,
                                pq_bits=4, trainset_rows=1000, device="cpu")
    assert st.n_rows == 3000
    idx = ivf_pq.build(torch.from_numpy(x[:600]), n_lists=4, pq_dim=8, pq_bits=4, seed=0)
    assert ivf_pq.extend(idx, x[:10]).n_rows == 610
    for index in (pc, st, idx):
        d, i = ivf_pq.search(index, torch.from_numpy(q), 5, n_probes=4, scan_algo="cluster_major")
        assert bool(torch.isfinite(d).all())
    with pytest.raises(ValueError, match="cluster_major"):
        ivf_pq.search(idx, torch.from_numpy(q), 5, scan_algo="bogus")
    qs = torch.from_numpy(q[:3])
    a = ivf_pq.search(idx, qs, 5, n_probes=4)
    b = ivf_pq.search(idx, qs, 5, n_probes=4, scan_algo="query_major")
    assert torch.equal(a[1], b[1])
