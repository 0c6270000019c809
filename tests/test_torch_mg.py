"""Multi-device indexes and k-means: the port on eight CPU devices
(``devices=["cpu"] * 8``) against the JAX package on its eight-device CPU
mesh (tests/conftest.py), and the reference's own mg tests on the port.

Where both packages search the same shards (brute force, or the reference's
index carried across by ``interop.mg_index_from_numpy``) the merged top-k
agree: distances to rtol 1e-5 / atol 1e-4, ids equal except at ties within
that tolerance. CAGRA's search draws other random entry points in the port,
so the carried CAGRA index is held to the reference's recall floor and to
the reference's own recall within 0.05.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cuvs_tpu import mg as jax_mg
from cuvs_tpu.cluster import kmeans as jax_kmeans
from cuvs_tpu.mg import snmg as jax_snmg
from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu_torch import interop, mg
from cuvs_tpu_torch.cluster import kmeans, kmeans_balanced
from cuvs_tpu_torch.mg import snmg
from cuvs_tpu_torch.neighbors import filters, ivf_flat, ivf_pq, refine
from cuvs_tpu_torch.selection.select_k import merge_parts
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)

RNG = np.random.default_rng(41)
CPU8 = ["cpu"] * 8
TOL = dict(rtol=1e-5, atol=1e-4)


def _carried(ref):
    return interop.mg_index_from_numpy(ref.shards, ref.row_offsets, ref.algo, ref.mode,
                                       ref.n_rows, devices=CPU8)


def _same_results(td, ti, jd, ji):
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(td.numpy(), jd, **TOL)
    ids_match_modulo_ties(ti.numpy(), ji, jd, **TOL)


def test_device_list_of_eight_cpus():
    """The port's counterpart of the reference's 8-device mesh: a list of
    eight (repeated) CPU devices; with no device named it needs the card."""
    x = make_blobs(RNG, 800, 8)
    idx = mg.build(x, algo="brute_force", devices=CPU8)
    assert len(idx.shards) == 8 and all(s.device.type == "cpu" for s in idx.shards)
    assert len(jax.devices()) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mg.default_devices()


@pytest.mark.parametrize("algo", ["brute_force", "ivf_flat", "cagra"])
def test_sharded_search(algo):
    """tests/test_mg.py::test_sharded_search on the port (its floors)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((8000, 24)) * 2).astype(np.float32)
    q = (rng.standard_normal((64, 24)) * 2).astype(np.float32)
    kw = {"ivf_flat": dict(n_lists=16, seed=0),
          "cagra": dict(intermediate_graph_degree=48, graph_degree=24, seed=0)}.get(algo, {})
    idx = mg.build(x, algo=algo, mode="sharded", devices=CPU8, **kw)
    d, i = mg.search(idx, q, 10, **({"n_probes": 16} if algo == "ivf_flat" else {}))
    gtd, gti = naive_knn(q, x, 10)
    floor = {"brute_force": 0.999, "ivf_flat": 0.999, "cagra": 0.85}[algo]
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= floor


def test_sharded_bf_matches_reference_with_unequal_shards():
    """n = 4003: the reference pads the last shard with zero rows and masks
    them at the merge; the port's last shard is shorter."""
    x = make_blobs(RNG, 4003, 16)
    q = make_blobs(RNG, 20, 16)
    ref = jax_mg.build(x, algo="brute_force", mode="sharded")
    idx = mg.build(x, algo="brute_force", mode="sharded", devices=CPU8)
    assert [s.size for s in idx.shards] == [501] * 7 + [496]
    d, i = mg.search(idx, q, 10)
    _same_results(d, i, *jax_mg.search(ref, q, 10))
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti) >= 0.999


@pytest.mark.parametrize("algo", ["brute_force", "ivf_flat", "ivf_pq"])
def test_carried_index_searches_as_the_reference(algo):
    """Built once in JAX, searched in both packages: the same shards give the
    same merged top-k (padded rows of the reference's last shard masked)."""
    rng = np.random.default_rng(9)
    x = make_blobs(rng, 4001, 32, n_centers=30)
    q = make_blobs(rng, 24, 32, n_centers=30)
    kw = {"ivf_flat": dict(n_lists=8, seed=0), "ivf_pq": dict(n_lists=8, pq_dim=16, seed=0)}
    ref = jax_mg.build(x, algo=algo, mode="sharded", **kw.get(algo, {}))
    skw = {} if algo == "brute_force" else dict(n_probes=4, scan_algo="query_major")
    idx = _carried(ref)
    assert len(idx.shards) == 8 and idx.n_rows == 4001
    d, i = mg.search(idx, q, 10, **skw)
    _same_results(d, i, *jax_mg.search(ref, q, 10, **skw))


def test_carried_replicated_index_is_one_replica_on_every_device():
    x = make_blobs(RNG, 1000, 16)
    q = make_blobs(RNG, 12, 16)
    ref = jax_mg.build(x, algo="brute_force", mode="replicated")
    idx = interop.mg_index_from_numpy(ref.shards, ref.row_offsets, ref.algo, ref.mode,
                                      ref.n_rows, devices=["cpu"] * 3)
    assert idx.mode == "replicated" and len(idx.shards) == 3 and idx.row_offsets == [0] * 3
    _same_results(*mg.search(idx, q, 10), *jax_mg.search(ref, q, 10))


def test_carried_cagra_holds_the_reference_recall():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4000, 24)) * 2).astype(np.float32)
    q = (rng.standard_normal((64, 24)) * 2).astype(np.float32)
    ref = jax_mg.build(x, algo="cagra", intermediate_graph_degree=32, graph_degree=16, seed=0)
    idx = _carried(ref)
    for shard, s in zip(idx.shards, range(8)):
        np.testing.assert_array_equal(shard.graph.numpy(), np.asarray(ref.shards.graph[s]))
    gtd, gti = naive_knn(q, x, 10)
    jd, ji = jax_mg.search(ref, q, 10)
    d, i = mg.search(idx, q, 10)
    rec, ref_rec = calc_recall(i.numpy(), gti), calc_recall(np.asarray(ji), gti)
    assert rec >= 0.85 and abs(rec - ref_rec) <= 0.05, (rec, ref_rec)


def test_replicated_search():
    x = make_blobs(RNG, 4000, 16)
    q = make_blobs(RNG, 100, 16)
    idx = mg.build(x, algo="brute_force", mode="replicated", devices=CPU8)
    # a repeated device shares the replica's tensors
    assert all(s.dataset.data_ptr() == idx.shards[0].dataset.data_ptr() for s in idx.shards)
    d, i = mg.search(idx, q, 10)
    ref = jax_mg.build(x, algo="brute_force", mode="replicated")
    _same_results(d, i, *jax_mg.search(ref, q, 10))


def test_replicated_round_robin():
    x = make_blobs(RNG, 4000, 16)
    q = make_blobs(RNG, 64, 16)
    idx = mg.build(x, algo="brute_force", mode="replicated", devices=CPU8)
    gtd, gti = naive_knn(q, x, 10)
    direct = snmg.brute_force.search(idx.shards[0], torch.from_numpy(q), 10)
    seen = set()
    for _ in range(3):  # consecutive batches land on successive replicas
        before = snmg._rr_counter[0]
        d, i = mg.search(idx, q, 10, routing="round_robin")
        assert snmg._rr_counter[0] == before + 1
        seen.add(before % len(idx.shards))
        assert torch.equal(i, direct[1]) and torch.equal(d, direct[0])
        assert calc_recall(i.numpy(), gti) >= 0.999
    assert len(seen) == 3


def test_replicated_load_balancer_reads_a_bitmap_per_query():
    """Each replica gets its slice of the batch and of a per-query filter."""
    x = make_blobs(RNG, 1000, 8)
    q = make_blobs(RNG, 37, 8)
    mask = RNG.random((37, 1000)) > 0.5
    idx = mg.build(x, algo="brute_force", mode="replicated", devices=["cpu"] * 3)
    d, i = mg.search(idx, q, 5, prefilter=filters.from_mask(mask, device="cpu"))
    want = snmg.brute_force.search(idx.shards[0], torch.from_numpy(q), 5,
                                   prefilter=filters.from_mask(mask, device="cpu"))
    assert torch.equal(i, want[1])
    assert mask[np.arange(37)[:, None], i.numpy()].all()


def test_distributed_ivf_flat_build_matches_loop_build():
    """Both are exact at n_probes = n_lists (tests/test_mg.py:78-92); the
    distributed build's centres are a single-device build's on the same rows."""
    n = 8000
    x = make_blobs(RNG, n, 16)
    q = make_blobs(RNG, 48, 16)
    fast = mg.build(x, algo="ivf_flat", mode="sharded", devices=CPU8, n_lists=16, seed=0)
    slow = mg.build(x, algo="ivf_flat", mode="sharded", devices=CPU8, distributed_build="off",
                    n_lists=16, seed=0)
    gtd, gti = naive_knn(q, x, 10)
    for idx in (fast, slow):
        d, i = mg.search(idx, q, 10, n_probes=16)
        assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.999
    single = ivf_flat.build(x, n_lists=16, seed=0, device="cpu")
    assert all(torch.equal(s.centers, single.centers) for s in fast.shards)
    assert sum(s.n_rows for s in fast.shards) == n


def test_distributed_ivf_flat_build_honors_storage_dtype():
    x = make_blobs(RNG, 8000, 16)
    q = make_blobs(RNG, 48, 16)
    idx = mg.build(x, algo="ivf_flat", mode="sharded", devices=CPU8, n_lists=16, seed=0,
                   storage_dtype=torch.int8)
    assert all(s.sorted_data.dtype == torch.int8 for s in idx.shards)
    scales = {float(s.q_scale) for s in idx.shards}
    assert scales == {float(np.abs(x).max()) / 127.0} or len(scales) == 1
    d, i = mg.search(idx, q, 10, n_probes=16)
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.9


@pytest.mark.parametrize("kind", ["bitset", "bitmap", "udf"])
def test_sharded_prefilter_over_global_ids_matches_reference(kind):
    x = make_blobs(RNG, 3001, 16)
    q = make_blobs(RNG, 16, 16)
    keep = RNG.random((16, 3001) if kind == "bitmap" else 3001) > 0.5
    if kind == "udf":
        jf = jax_filters.udf_filter(lambda qid, sid: jax.numpy.asarray(keep)[sid])
        tf = filters.udf_filter(lambda qid, sid: torch.from_numpy(keep)[sid])
    else:
        jf, tf = jax_filters.from_mask(keep), filters.from_mask(keep, device="cpu")
    ref = jax_mg.build(x, algo="brute_force", mode="sharded")
    idx = mg.build(x, algo="brute_force", mode="sharded", devices=CPU8)
    d, i = mg.search(idx, q, 10, prefilter=tf)
    _same_results(d, i, *jax_mg.search(ref, q, 10, prefilter=jf))
    ok = keep[np.arange(16)[:, None], i.numpy()] if kind == "bitmap" else keep[i.numpy()]
    assert ok[np.isfinite(d.numpy())].all()


def test_mg_kmeans_matches_quality():
    """tests/test_mg.py::test_mg_kmeans_matches_quality on the port."""
    rng = np.random.default_rng(0)
    x = make_blobs(rng, 8000, 16, n_centers=8)
    centers_mg, inertia_mg = mg.kmeans_fit(x, 8, devices=CPU8, seed=1)
    _, _, inertia_sg, _ = kmeans.fit(x, n_clusters=8, seed=1, device="cpu")
    assert centers_mg.shape == (8, 16)
    assert float(inertia_mg) <= float(inertia_sg) * 1.05


def test_mg_kmeans_from_the_same_centres_matches_single_device_and_reference():
    """The mg Lloyd loop over 8 blocks (the last one shorter) from given
    centres: the single-device fit's centres, and the reference's mg fit fed
    the same start through its seeding hook."""
    rng = np.random.default_rng(2)
    x = make_blobs(rng, 6001, 16, n_centers=6)
    init = x[:6]
    c_mg, inertia_mg = mg.kmeans_fit(x, 6, devices=CPU8, max_iter=20, init_centers=init)
    c_sg, _, _, n_iter = kmeans.fit(x, n_clusters=6, init_centers=init, max_iter=20,
                                    device="cpu")
    np.testing.assert_allclose(c_mg.numpy(), c_sg.numpy(), rtol=1e-4, atol=1e-4)
    # converged: the last assignment's cost is the final centres' within 1e-3
    cost = float(kmeans.cluster_cost(x, c_mg, device="cpu"))
    assert n_iter < 20 and abs(float(inertia_mg) - cost) <= 1e-3 * cost
    j_c, _, _, _ = jax_kmeans.fit(x, n_clusters=6, init_centers=init, max_iter=20)
    np.testing.assert_allclose(c_mg.numpy(), np.asarray(j_c), rtol=1e-4, atol=1e-4)


def test_mg_serialize_roundtrip(tmp_path):
    x = make_blobs(RNG, 2000, 16)
    q = make_blobs(RNG, 16, 16)
    for algo, kw in (("brute_force", {}), ("ivf_flat", dict(n_lists=8, seed=0))):
        idx = mg.build(x, algo=algo, devices=CPU8, **kw)
        d1, i1 = mg.search(idx, q, 5)
        p = str(tmp_path / algo)
        snmg.save(p, idx)
        loaded = snmg.load(p, devices=CPU8)
        assert loaded.row_offsets == idx.row_offsets and loaded.n_rows == idx.n_rows
        d2, i2 = mg.search(loaded, q, 5)
        assert torch.equal(i1, i2) and torch.equal(d1, d2)


def test_loads_the_reference_directory_and_the_reference_loads_the_port(tmp_path):
    x = make_blobs(RNG, 4000, 16)  # 8 equal shards: the reference can stack the port's
    q = make_blobs(RNG, 16, 16)
    ref = jax_mg.build(x, algo="ivf_flat", mode="sharded", n_lists=8, seed=0)
    jax_snmg.save(str(tmp_path / "ref"), ref)
    loaded = snmg.load(str(tmp_path / "ref"), devices=CPU8)
    _same_results(*mg.search(loaded, q, 10, n_probes=8), *jax_mg.search(ref, q, 10, n_probes=8))
    idx = mg.build(x, algo="brute_force", devices=CPU8)
    snmg.save(str(tmp_path / "port"), idx)
    back = jax_snmg.load(str(tmp_path / "port"))
    assert back.n_rows == 4000 and list(np.asarray(back.row_offsets)) == idx.row_offsets
    _same_results(*mg.search(idx, q, 10), *jax_mg.search(back, q, 10))
    with pytest.raises(ValueError, match="magic"):
        (tmp_path / "port" / "mg_header.json").write_text('{"magic": "evil"}')
        snmg.load(str(tmp_path / "port"), devices=CPU8)


def test_flat_device_list_matches_the_reference_2d_mesh():
    """tests/test_mg.py's 2-D ('dcn', 'ici') mesh: the port has no mesh
    axes; its flat list of eight devices gives the same results."""
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("dcn", "ici"))
    x = make_blobs(RNG, 4000, 16)
    q = make_blobs(RNG, 32, 16)
    ref = jax_mg.build(x, algo="brute_force", mode="sharded", mesh=mesh)
    idx = mg.build(x, algo="brute_force", mode="sharded", devices=CPU8)
    d, i = mg.search(idx, q, 10)
    _same_results(d, i, *jax_mg.search(ref, q, 10, mesh=mesh))
    centers, inertia = mg.kmeans_fit(x, 8, devices=CPU8, max_iter=5, seed=0)
    assert centers.shape == (8, 16) and torch.isfinite(inertia)


def test_streaming_sharded_build():
    """tests/test_mg.py::test_streaming_sharded_build: unequal slices."""
    rng = np.random.default_rng(4)
    slices = [rng.standard_normal((800 if i < 15 else 400, 96), dtype=np.float32)
              for i in range(16)]
    x = np.concatenate(slices)
    q = rng.standard_normal((48, 96), dtype=np.float32)
    idx = mg.build_streaming(lambda i: slices[i], 16, devices=CPU8, n_lists=16,
                             trainset_rows=1600)
    assert idx.n_rows == x.shape[0] and len(idx.shards) == 8
    assert [s.n_rows for s in idx.shards] == [1600] * 7 + [1200]
    assert all(s.sorted_data.dtype == torch.int8 for s in idx.shards)
    d, i = mg.search(idx, q, 10, n_probes=16)
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti) >= 0.85


def test_streaming_sharded_build_ivf_pq():
    """The reference's test_streaming_sharded_build_ivf_pq, which crashes
    there (its _unify_rows pads sorted_code_norms by a negative width): the
    port's unstacked shards need no padding. Recall >= 0.9 after refine, and
    the search equals the per-shard streaming builds merged by merge_parts."""
    rng = np.random.default_rng(11)
    slices = [rng.standard_normal((600, 48), dtype=np.float32) for _ in range(16)]
    x = np.concatenate(slices)
    q = x[rng.integers(0, x.shape[0], 48)] + 0.01 * rng.standard_normal((48, 48)).astype(
        np.float32)
    idx = mg.build_streaming(lambda i: slices[i], 16, devices=CPU8, algo="ivf_pq", n_lists=8,
                             pq_dim=12, trainset_rows=1200)
    assert idx.algo == "ivf_pq" and idx.n_rows == x.shape[0]
    d, i = mg.search(idx, q, 40, n_probes=8)
    dd, ii = refine.refine(x, q, i, 10, device="cpu")
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(ii.numpy(), gti, dd.numpy(), gtd) >= 0.9
    parts_d, parts_i = [], []
    for s in range(8):
        sub = ivf_pq.build_streaming(lambda j, s=s: slices[2 * s + j], 2, n_lists=8, pq_dim=12,
                                     trainset_rows=1200, device="cpu")
        pd_, pi_ = ivf_pq.search(sub, torch.from_numpy(q), 40, n_probes=8)
        parts_d.append(pd_)
        parts_i.append(pi_ + 1200 * s)
    md, mi = merge_parts(parts_d, parts_i, 40)
    assert torch.equal(mi, i) and torch.equal(md, d)


def test_streaming_sharded_build_raises_as_the_reference():
    sl = lambda i: np.zeros((10, 8), np.float32)  # noqa: E731
    with pytest.raises(ValueError, match="slice per shard"):
        mg.build_streaming(sl, 3, devices=["cpu"] * 4, n_lists=2)
    with pytest.raises(ValueError, match="ivf_flat/ivf_pq"):
        mg.build_streaming(sl, 4, devices=["cpu"] * 4, algo="cagra")


@pytest.mark.parametrize("algo", ["ivf_flat", "ivf_pq"])
def test_sharded_search_runs_fused_scan(algo, monkeypatch):
    """Every shard runs the fused scan (its plain version on CPU tensors),
    as the reference's shards do under shard_map."""
    from cuvs_tpu_torch.neighbors import ivf_scan

    called = {"n": 0}
    target = "cluster_major_scan_fused" if algo == "ivf_flat" else "cluster_major_scan_pq_fused"
    orig = getattr(ivf_scan, target)

    def spy(*a, **kw):
        called["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(ivf_scan, target, spy)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4096, 32)) * 2).astype(np.float32)
    q = (rng.standard_normal((128, 32)) * 2).astype(np.float32)
    kw = dict(n_lists=8, seed=0, **({"pq_dim": 8} if algo == "ivf_pq" else {}))
    idx = mg.build(x, algo=algo, mode="sharded", devices=CPU8, **kw)
    d, i = mg.search(idx, q, 10, n_probes=8, scan_algo="fused")
    assert called["n"] == 8
    gtd, gti = naive_knn(q, x, 10)
    floor = 0.95 if algo == "ivf_flat" else 0.70  # PQ is approximate
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= floor


def test_balanced_centres_of_the_distributed_build_are_kmeans_balanced_fit():
    x = make_blobs(RNG, 2000, 8)
    idx = mg.build(x, algo="ivf_flat", devices=["cpu"] * 4, n_lists=8, seed=3,
                   kmeans_trainset_fraction=0.5)
    want = kmeans_balanced.fit(x, 8, kmeans_balanced.BalancedParams(
        n_clusters=8, n_iters=20, trainset_fraction=0.5, seed=3), device="cpu")
    assert all(torch.equal(s.centers, want) for s in idx.shards)
