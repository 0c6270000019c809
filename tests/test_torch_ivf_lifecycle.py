"""Index lifecycle in the port against the JAX package, on the CPU: IVF-Flat
and IVF-PQ ``extend``, ``build_streaming`` (host and device mode),
PER_CLUSTER codebook training and encoding, and ``refine_host``.

Parity: JAX-built indexes are carried across (``interop``) and extended in
both packages with the same rows; the streaming builds run with both
packages' ``kmeans_balanced.fit`` patched to return the same centers. Lists,
ids, rows and codes must then be identical, except rows whose two nearest
centers are within 1e-5 relative of each other (a label there may go either
way). Norms are f32 sums in another order (rtol 1e-6); centers and
codebooks from the same inputs rtol 1e-5. The port's int8 ``extend``
deliberately labels new rows by their float values (the reference labels
their int8 codes). Own builds use the port's RNG and are held to the
reference tests' recall floors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.cluster import kmeans_balanced as jax_kmeans
from cuvs_tpu.neighbors import ivf_flat as jax_flat
from cuvs_tpu.neighbors import ivf_pq as jax_pq
from cuvs_tpu.neighbors import refine as jax_refine
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.core import bitpack
from cuvs_tpu_torch.neighbors import ivf_flat, ivf_pq, ivf_scan, refine
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(51)
    return make_blobs(rng, 3000, 32, n_centers=30), make_blobs(rng, 40, 32, n_centers=30)


def _flat_carried(j):
    return interop.ivf_flat_index_from_numpy(
        j.centers, j.center_norms, j.sorted_data, j.sorted_norms, j.lists.offsets, j.lists.sizes,
        j.lists.ids, j.lists.labels, j.q_scale, j.metric, j.window, j.n_rows, device="cpu",
        adaptive_centers=j.adaptive_centers)


def _pq_carried(j):
    return interop.ivf_pq_index_from_numpy(
        j.centers, j.center_norms, j.centers_rot, j.rotation, j.pq_centers, j.sorted_codes,
        j.lists.offsets, j.lists.sizes, j.lists.ids, j.lists.labels, j.metric, j.window,
        j.n_rows, j.pq_bits, j.sorted_codes_t, j.sorted_code_norms, device="cpu",
        codebook_gen=j.codebook_gen, pq_dim=j.pq_dim_static)


def _near_ties(rows, centers):
    """Rows whose two nearest centers are within 1e-5 relative (float64)."""
    d = ((rows.astype(np.float64)[:, None, :] - np.asarray(centers, np.float64)[None]) ** 2).sum(2)
    two = np.sort(d, 1)[:, :2]
    return two[:, 1] - two[:, 0] <= 1e-5 * np.maximum(two[:, 1], 1e-30)


def _by_id(ids, *arrays):
    """The arrays' first len(ids) rows reordered by global id."""
    o = np.argsort(np.asarray(ids))
    return [np.asarray(a)[:len(o)][o] for a in arrays]


def _assert_same_lists(j, t, new_rows):
    """The port's index t holds the same rows in the same lists as the
    reference's j, except near-tie new rows' labels."""
    n = j.n_rows
    assert t.n_rows == n and t.window == j.window
    jl = _by_id(j.lists.ids[:n], j.lists.labels)[0]
    tl = _by_id(t.lists.ids[:n].numpy(), t.lists.labels.numpy())[0]
    tie = np.zeros(n, bool)
    tie[n - len(new_rows):] = _near_ties(new_rows, j.centers)
    assert np.array_equal(jl[~tie], tl[~tie])
    if not tie.any():  # then every position agrees
        np.testing.assert_array_equal(t.lists.ids.numpy(), np.asarray(j.lists.ids))
        np.testing.assert_array_equal(t.lists.offsets.numpy(), np.asarray(j.lists.offsets))


@pytest.mark.parametrize("case", ["plain", "ids", "adaptive", "train_only"])
def test_flat_extend_matches_reference(data, case):
    x, q = data
    kw = dict(n_lists=16, seed=0, adaptive_centers=case == "adaptive",
              add_data_on_build=case != "train_only")
    j = jax_flat.build(x[:2000], **kw)
    t = _flat_carried(j)
    new = x[2000:] + (2.0 if case == "adaptive" else 0.0)
    ids = np.arange(700000, 701000, dtype=np.int32) if case == "ids" else None
    j2 = jax_flat.extend(j, new, new_ids=ids)
    t2 = ivf_flat.extend(t, torch.from_numpy(new), new_ids=ids)
    _assert_same_lists(j2, t2, new)
    n = j2.n_rows
    jd, jn = _by_id(j2.lists.ids[:n], j2.sorted_data, j2.sorted_norms)
    td, tn = _by_id(t2.lists.ids[:n].numpy(), t2.sorted_data.numpy(), t2.sorted_norms.numpy())
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    np.testing.assert_allclose(t2.centers.numpy(), np.asarray(j2.centers), rtol=1e-5, atol=1e-6)
    if case == "adaptive":
        assert not np.allclose(t2.centers.numpy(), np.asarray(j.centers))
    jd, ji = jax_flat.search(j2, q, 10, n_probes=6, scan_algo="query_major")
    td, ti = ivf_flat.search(t2, torch.from_numpy(q), 10, n_probes=6, scan_algo="query_major")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)


def test_int8_extend_puts_every_row_in_its_nearest_list():
    """The reference labels an int8 index's new rows by their codes against
    the float centers, which sends some to another list (8.4% of these rows,
    q_scale 0.116); the port labels the float rows: every row that is not a
    near tie lands in its nearest list."""
    x = (np.random.default_rng(52).standard_normal((6000, 32)) * 3.0).astype(np.float32)
    new = x[5000:]

    def nearest_share(index, labels_by_id):
        d = ((new[:, None, :].astype(np.float64) - np.asarray(index.centers)[None]) ** 2).sum(2)
        ok = labels_by_id[5000:] == d.argmin(1)
        return (ok | _near_ties(new, np.asarray(index.centers))).mean()

    idx = ivf_flat.build(torch.from_numpy(x[:5000]), n_lists=32, seed=0, storage_dtype=torch.int8)
    idx2 = ivf_flat.extend(idx, torch.from_numpy(new))
    assert idx2.sorted_data.dtype == torch.int8 and torch.equal(idx2.q_scale, idx.q_scale)
    (lab,) = _by_id(idx2.lists.ids[:6000].numpy(), idx2.lists.labels.numpy())
    assert nearest_share(idx, lab) == 1.0
    j = jax_flat.build(x[:5000], n_lists=32, seed=0, storage_dtype=jnp.int8)
    j2 = jax_flat.extend(j, new)
    (jlab,) = _by_id(j2.lists.ids[:6000], j2.lists.labels)
    assert nearest_share(j, jlab) < 0.95  # the fault the port repairs


@pytest.mark.parametrize("codebook_gen", ["per_subspace", "per_cluster"])
@pytest.mark.parametrize("case", ["plain", "ids", "train_only"])
def test_pq_extend_matches_reference(data, codebook_gen, case):
    x, q = data
    j = jax_pq.build(x[:2000], n_lists=16, pq_dim=8, pq_bits=6, seed=0,
                     codebook_gen=codebook_gen, add_data_on_build=case != "train_only")
    new = x[2000:]
    ids = np.arange(700000, 701000, dtype=np.int32) if case == "ids" else None
    j2 = jax_pq.extend(j, new, new_ids=ids)
    t2 = ivf_pq.extend(_pq_carried(j), torch.from_numpy(new), new_ids=ids)
    _assert_same_lists(j2, t2, new)
    n = j2.n_rows
    S = t2.pq_dim
    jc = _by_id(j2.lists.ids[:n], np.asarray(
        bitpack.unpack(np.asarray(j2.sorted_codes[:n]), 6, S, device="cpu")))[0]
    tc = _by_id(t2.lists.ids[:n].numpy(), bitpack.unpack(t2.sorted_codes[:n], 6, S).numpy())[0]
    np.testing.assert_array_equal(tc, jc)
    if codebook_gen == "per_subspace":  # the reference pads its word rows to 8
        Sw = -(-S // 4)
        np.testing.assert_array_equal(t2.sorted_codes_t.numpy().view(np.uint32),
                                      np.asarray(j2.sorted_codes_t)[:Sw])
        np.testing.assert_allclose(t2.sorted_code_norms.numpy()[:n],
                                   np.asarray(j2.sorted_code_norms)[:n], rtol=1e-6)
    else:
        assert t2.sorted_codes_t is None
    jd, ji = jax_pq.search(j2, q, 10, n_probes=6, scan_algo="query_major")
    td, ti = ivf_pq.search(t2, torch.from_numpy(q), 10, n_probes=6, scan_algo="query_major")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)


def test_flat_extend_recall_floors():
    """tests/test_ivf_flat.py:90-165 on the port's own builds (smaller)."""
    rng = np.random.default_rng(53)
    x = make_blobs(rng, 6000, 16, n_centers=100)
    q = make_blobs(rng, 30, 16, n_centers=100)
    gtd, gti = naive_knn(q, x, 10)
    idx = ivf_flat.extend(ivf_flat.build(torch.from_numpy(x[:4000]), n_lists=32, seed=0),
                          torch.from_numpy(x[4000:]))
    assert idx.size == 6000
    d, i = ivf_flat.search(idx, torch.from_numpy(q), 10, n_probes=32)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.99
    # custom ids come back
    idx = ivf_flat.build(torch.from_numpy(x[:1000]), n_lists=16, seed=0)
    custom = np.arange(700000, 701000, dtype=np.int32)
    idx = ivf_flat.extend(idx, torch.from_numpy(x[1000:2000]), new_ids=custom)
    _, i = ivf_flat.search(idx, torch.from_numpy(x[1500:1510]), 1, n_probes=16)
    assert (i.numpy().ravel() == custom[500:510]).mean() >= 0.9
    # adaptive centers move; frozen ones do not
    for adaptive in (True, False):
        a = ivf_flat.build(torch.from_numpy(x[:2000]), n_lists=16, seed=0,
                           adaptive_centers=adaptive)
        b = ivf_flat.extend(a, torch.from_numpy(x[2000:4000] + 5.0))
        assert torch.equal(a.centers, b.centers) != adaptive
    # int8: extend quantizes with the existing scale; train-only then extend
    for sd, floor in ((None, 0.85), (torch.int8, 0.75)):
        t = ivf_flat.build(torch.from_numpy(x), n_lists=32, add_data_on_build=False,
                           storage_dtype=sd, seed=0)
        assert t.n_rows == 0
        t = ivf_flat.extend(t, torch.from_numpy(x))
        assert t.n_rows == 6000 and (sd is None or t.q_scale is not None)
        _, i = ivf_flat.search(t, torch.from_numpy(q), 10, n_probes=16)
        assert calc_recall(i.numpy(), gti) >= floor


def test_pq_extend_recall_floors():
    """tests/test_ivf_pq.py:151-190 on the port's own builds (codebooks from
    8 rows per code)."""
    rng = np.random.default_rng(54)
    x = make_blobs(rng, 6000, 32, n_centers=64)
    q = make_blobs(rng, 30, 32, n_centers=64)
    _, gti = naive_knn(q, x, 10)
    kw = dict(n_lists=32, pq_dim=16, seed=0, max_train_points_per_pq_code=8)
    idx = ivf_pq.extend(ivf_pq.build(torch.from_numpy(x[:4000]), **kw), torch.from_numpy(x[4000:]))
    assert idx.size == 6000
    _, i = ivf_pq.search(idx, torch.from_numpy(q), 40, n_probes=32)
    _, ri = refine.refine(torch.from_numpy(x), torch.from_numpy(q), i, 10)
    assert calc_recall(ri.numpy(), gti) >= 0.9
    idx = ivf_pq.build(torch.from_numpy(x), add_data_on_build=False, **kw)
    assert idx.n_rows == 0
    idx = ivf_pq.extend(idx, torch.from_numpy(x))
    _, i = ivf_pq.search(idx, torch.from_numpy(q), 10, n_probes=32)
    assert calc_recall(i.numpy(), gti) >= 0.7


def _fixed_centers(monkeypatch, centers):
    c = np.asarray(centers, np.float32)
    monkeypatch.setattr(jax_kmeans, "fit", lambda *a, **k: jnp.asarray(c))
    monkeypatch.setattr(kmeans_balanced, "fit", lambda x, *a, **k: torch.from_numpy(c).to(
        torch.as_tensor(x).device))


@pytest.mark.parametrize("mode", ["host", "device", "host-unaligned"])
def test_flat_build_streaming_matches_reference(monkeypatch, mode):
    rng = np.random.default_rng(55)
    x = make_blobs(rng, 4000, 96, n_centers=40)  # 96: rows padded to 128 unless unaligned
    slices = [x[i * 1000:(i + 1) * 1000] for i in range(4)]
    _fixed_centers(monkeypatch, x[::250][:16])
    host, align = mode != "device", mode != "host-unaligned"
    j = jax_flat.build_streaming(lambda i: slices[i] if host else jnp.asarray(slices[i]), 4,
                                 n_lists=16, trainset_rows=2000, align_dim=align)
    t = ivf_flat.build_streaming(
        lambda i: slices[i] if host else torch.from_numpy(slices[i]), 4, n_lists=16,
        trainset_rows=2000, align_dim=align, device="cpu")
    assert t.sorted_data.dtype == torch.int8 and t.sorted_data.shape == j.sorted_data.shape
    assert t.sorted_data.shape[1] == (128 if align else 96)
    assert float(t.q_scale) == float(j.q_scale) and t.window == j.window
    np.testing.assert_array_equal(t.sorted_data.numpy(), np.asarray(j.sorted_data))
    np.testing.assert_array_equal(t.lists.labels.numpy(), np.asarray(j.lists.labels))
    np.testing.assert_array_equal(t.lists.ids.numpy(), np.asarray(j.lists.ids))
    np.testing.assert_array_equal(t.lists.offsets.numpy(), np.asarray(j.lists.offsets))
    np.testing.assert_allclose(t.sorted_norms.numpy(), np.asarray(j.sorted_norms),
                               rtol=0 if host else 1e-6)
    q = x[7::100]
    jd, ji = jax_flat.search(j, q, 10, n_probes=6, scan_algo="query_major")
    td, ti = ivf_flat.search(t, torch.from_numpy(q), 10, n_probes=6, scan_algo="query_major")
    # |q|^2 + |x|^2 - 2 q.x with exact int8 dots: the two f32 sums of |q|^2
    # (up to 3.6e3 here) may differ by a few of its ulps
    atol = 4e-7 * float((q * q).sum(1).max())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=atol)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, atol)


def test_flat_build_streaming_host_mode_lane_aligned():
    """tests/test_ivf_flat.py::test_streaming_build_host_mode_lane_aligned."""
    rng = np.random.default_rng(3)
    x = make_blobs(rng, 12000, 96, n_centers=64)
    q = make_blobs(rng, 50, 96, n_centers=64)
    idx = ivf_flat.build_streaming(lambda i: x[i * 3000:(i + 1) * 3000], 4, n_lists=64,
                                   trainset_rows=4000, seed=0, device="cpu")
    assert idx.sorted_data.shape[1] % 128 == 0 and idx.sorted_data.dtype == torch.int8
    _, gti = naive_knn(q, x, 10)
    _, i = ivf_flat.search(idx, torch.from_numpy(q), 10, n_probes=24)
    assert calc_recall(i.numpy(), gti) >= 0.8


@pytest.mark.parametrize("serving_layout", [True, False])
def test_pq_build_streaming_matches_reference(monkeypatch, serving_layout):
    """Both packages' coarse centers and codebooks patched to the same arrays
    (pq_dim * pq_len == d: both rotations are the identity): the lists, the
    packed codes and the serving layout (without the reference's 8-row pad)
    equal the reference's. Without the layout, ``fused`` and big-batch
    ``auto`` run cluster_major, as the reference's search does."""
    rng = np.random.default_rng(59)
    x = make_blobs(rng, 4000, 40, n_centers=40)
    q = make_blobs(rng, 48, 40, n_centers=40)
    slices = [x[i * 1000:(i + 1) * 1000] for i in range(4)]
    _fixed_centers(monkeypatch, x[::250][:16])
    books = (rng.standard_normal((10, 256, 4)) * x.std()).astype(np.float32)
    monkeypatch.setattr(jax_pq, "_train_codebooks", lambda *a, **k: jnp.asarray(books))
    monkeypatch.setattr(ivf_pq, "_train_codebooks", lambda *a, **k: torch.from_numpy(books))
    kw = dict(n_lists=16, pq_dim=10, trainset_rows=2000, serving_layout=serving_layout)
    j = jax_pq.build_streaming(lambda i: slices[i], 4, **kw)
    t = ivf_pq.build_streaming(lambda i: slices[i], 4, device="cpu", **kw)
    assert torch.equal(t.rotation, torch.eye(40)) and t.window == j.window
    for name in ("labels", "ids", "offsets", "sizes"):
        np.testing.assert_array_equal(getattr(t.lists, name).numpy(),
                                      np.asarray(getattr(j.lists, name)))
    np.testing.assert_array_equal(t.sorted_codes.numpy().view(np.uint32),
                                  np.asarray(j.sorted_codes))
    n = t.n_rows
    if serving_layout:
        jt = np.asarray(j.sorted_codes_t)
        np.testing.assert_array_equal(t.sorted_codes_t.numpy().view(np.uint32), jt[:3])
        assert not jt[3:].any()  # the reference's pad rows
        np.testing.assert_allclose(t.sorted_code_norms.numpy()[:n],
                                   np.asarray(j.sorted_code_norms)[:n], rtol=1e-6)
        jd, ji = jax_pq.search(j, q, 10, n_probes=5, scan_algo="query_major")
        td, ti = ivf_pq.search(t, torch.from_numpy(q), 10, n_probes=5, scan_algo="query_major")
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
        ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)
        return
    assert t.sorted_codes_t is None and j.sorted_codes_t is None
    jd, ji = jax_pq.search(j, q, 10, n_probes=5, scan_algo="cluster_major")
    cm = ivf_pq.search(t, torch.from_numpy(q), 10, n_probes=5, scan_algo="cluster_major")
    np.testing.assert_allclose(cm[0].numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(cm[1].numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)
    for algo in ("fused", "auto"):  # 48 queries x 5 probes >= 4 x 16 lists
        got = ivf_pq.search(t, torch.from_numpy(q), 10, n_probes=5, scan_algo=algo)
        assert torch.equal(got[0], cm[0]) and torch.equal(got[1], cm[1])


def test_pq_chunked_helpers_match_reference():
    """_gather_codes, _pack_chunked and _codes_t_chunked against the
    reference's on the same codes, at a chunk that leaves a remainder."""
    rng = np.random.default_rng(60)
    codes = rng.integers(0, 256, (2500, 10)).astype(np.uint8)
    order = rng.permutation(2500)
    su8 = ivf_pq._gather_codes(torch.from_numpy(codes), torch.from_numpy(order), 256, 700)
    jsu8 = jax_pq._gather_codes(jnp.asarray(codes), jnp.asarray(order.astype(np.int32)), 256, 700)
    np.testing.assert_array_equal(su8.numpy(), np.asarray(jsu8))
    for bits in (6, 8):
        c = su8 & ((1 << bits) - 1)
        np.testing.assert_array_equal(
            ivf_pq._pack_chunked(c, bits, 700).numpy().view(np.uint32),
            np.asarray(jax_pq._pack_chunked(jnp.asarray(c.numpy()), bits, 700)))
    np.testing.assert_array_equal(ivf_pq._codes_t_chunked(su8, 700).numpy().view(np.uint32),
                                  np.asarray(jax_pq._codes_t_chunked(jsu8, 700))[:3])


def test_pq_build_streaming_matches_in_memory():
    """tests/test_ivf_pq.py::test_build_streaming_matches_in_memory at half
    its rows, both codebooks trained on about 1000 rows:
    recall within 0.05 of the in-memory build and the chunked serving layout
    equal to the one-shot helper's."""
    rng = np.random.default_rng(2)
    slices = [make_blobs(rng, 1250 if i < 5 else 650, 96, n_centers=64) for i in range(6)]
    x = np.concatenate(slices)
    q = make_blobs(rng, 40, 96, n_centers=64)
    _, gti = naive_knn(q, x, 10)
    idx = ivf_pq.build_streaming(lambda i: slices[i], 6, n_lists=32, pq_dim=48,
                                 trainset_rows=1000, device="cpu")
    assert idx.n_rows == x.shape[0]
    _, i = ivf_pq.search(idx, torch.from_numpy(q), 10, n_probes=32)
    idx2 = ivf_pq.build(torch.from_numpy(x), n_lists=32, pq_dim=48, seed=0,
                        max_train_points_per_pq_code=4)
    _, i2 = ivf_pq.search(idx2, torch.from_numpy(q), 10, n_probes=32)
    assert calc_recall(i.numpy(), gti) >= calc_recall(i2.numpy(), gti) - 0.05
    cs = bitpack.unpack(idx.sorted_codes[:idx.n_rows], idx.pq_bits, idx.pq_dim)
    assert torch.equal(idx.sorted_codes_t, ivf_scan.pack_codes_transposed(cs, idx.window))
    # the chunked helpers at a chunk that leaves a remainder
    su8 = ivf_pq._gather_codes(cs.to(torch.uint8), torch.arange(idx.n_rows), idx.window, 700)
    assert torch.equal(ivf_pq._pack_chunked(su8, 8, 700), idx.sorted_codes)
    assert torch.equal(ivf_pq._codes_t_chunked(su8, 700), idx.sorted_codes_t)


def _pc_inputs():
    rng = np.random.default_rng(56)
    sizes = np.array([300, 5, 0, 120, 256, 40], np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    sorted_res = rng.standard_normal((int(sizes.sum()) + 256, 4, 2)).astype(np.float32)
    return sorted_res, offsets, sizes


def test_train_codebooks_per_cluster_matches_reference_from_the_same_initial_rows():
    sorted_res, offsets, sizes = _pc_inputs()
    key, book, n_iters, train_w, pq_dim = jax.random.PRNGKey(7), 16, 6, 256, 4
    ref = np.asarray(jax_pq._train_codebooks_per_cluster(
        key, jnp.asarray(sorted_res), jnp.asarray(offsets), jnp.asarray(sizes), book, n_iters,
        train_w, cluster_chunk=4))
    # the reference's own draws: per list, randint over its valid subvectors
    init = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, c), (book,), 0, max(min(int(s), train_w), 1) * pq_dim))
        for c, s in enumerate(sizes)])
    got = ivf_pq._train_codebooks_per_cluster(
        torch.from_numpy(sorted_res), torch.from_numpy(offsets), torch.from_numpy(sizes),
        torch.from_numpy(init).long(), n_iters, train_w)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def _quant_error(books, sorted_res, offsets, sizes, train_w):
    err, cnt = 0.0, 0
    for c, (o, s) in enumerate(zip(offsets, sizes)):
        xs = sorted_res[o:o + min(s, train_w)].reshape(-1, sorted_res.shape[2])
        if len(xs):
            err += ((xs[:, None, :] - books[c][None]) ** 2).sum(2).min(1).sum()
            cnt += len(xs)
    return err / cnt


def test_per_cluster_em_error_within_5_percent_of_reference():
    sorted_res, offsets, sizes = _pc_inputs()
    book, train_w = 16, 256
    ref = np.asarray(jax_pq._train_codebooks_per_cluster(
        jax.random.PRNGKey(0), jnp.asarray(sorted_res), jnp.asarray(offsets), jnp.asarray(sizes),
        book, 25, train_w))
    gen = torch.Generator().manual_seed(0)
    init = ivf_pq._init_indices_per_cluster(gen, torch.from_numpy(sizes), train_w, 4, book)
    got = ivf_pq._train_codebooks_per_cluster(
        torch.from_numpy(sorted_res), torch.from_numpy(offsets), torch.from_numpy(sizes), init,
        25, train_w).numpy()
    e_ref = _quant_error(ref, sorted_res, offsets, sizes, train_w)
    assert _quant_error(got, sorted_res, offsets, sizes, train_w) <= 1.05 * e_ref


def test_encode_per_cluster_matches_reference():
    rng = np.random.default_rng(57)
    res = rng.standard_normal((900, 16)).astype(np.float32)
    labels = rng.integers(0, 6, 900).astype(np.int32)
    books = rng.standard_normal((6, 32, 4)).astype(np.float32)
    ref = np.asarray(jax_pq._encode_per_cluster(jnp.asarray(res), jnp.asarray(labels),
                                                jnp.asarray(books)))
    got = ivf_pq._encode_per_cluster(torch.from_numpy(res), torch.from_numpy(labels),
                                     torch.from_numpy(books))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


class _Reader:
    """An on-disk style source: ``read(start, count)``, counting its calls."""

    def __init__(self, x):
        self.x, self.calls = x, 0

    def read(self, start, count):
        self.calls += 1
        return self.x[start:start + count]


@pytest.mark.parametrize("source", ["numpy", "memmap", "reader"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
def test_refine_host_matches_reference(tmp_path, source, metric):
    rng = np.random.default_rng(58)
    x = rng.standard_normal((5000, 24)).astype(np.float32)
    q = rng.standard_normal((30, 24)).astype(np.float32)
    cand = rng.integers(0, 5000, (30, 20)).astype(np.int32)
    cand[::7, 3] = -1  # invalid slots: +inf, id 0
    if source == "memmap":
        src = np.memmap(tmp_path / "x.bin", dtype=np.float32, mode="w+", shape=x.shape)
        src[:] = x
    else:
        src = _Reader(x) if source == "reader" else x
    jd, ji = jax_refine.refine_host(x, q, cand, 10, metric=metric, batch=16)
    td, ti = refine.refine_host(src, torch.from_numpy(q), cand, 10, metric=metric, batch=16,
                                device="cpu")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)
    if source == "reader":  # spans coalesce: fewer reads than candidates
        assert src.calls < cand.size
