"""CAGRA: the port against the JAX package on an index carried across
(``interop.cagra_index_from_numpy``), and the port's own builds against
exact k-NN, on the CPU.

Tolerances: the beam search of one chunk, given the reference's own random
seeds (cagra.py:580), returns at least 99% of the reference's (query, rank)
ids and a recall within 0.005 of the reference's, in float32 and bfloat16
compute (the products are summed in another order, so near-ties may swap and
steer a beam elsewhere). ``extend``, given the reference's search output,
builds exactly the reference's graph. The port's own builds draw other random
numbers and are held to tests/test_cagra.py's recall floors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import cagra as jax_cagra
from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.neighbors import cagra, filters, graph_core
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)

RNG = np.random.default_rng(21)


def _data(n, dim, nq, rng=RNG):
    # one broad cloud: a CAGRA graph over separated blobs is not connected
    return ((rng.standard_normal((n, dim)) * 2).astype(np.float32),
            (rng.standard_normal((nq, dim)) * 2).astype(np.float32))


def _carried(jidx):
    return interop.cagra_index_from_numpy(np.asarray(jidx.dataset), np.asarray(jidx.dataset_norms),
                                          np.asarray(jidx.graph), jidx.metric, device="cpu")


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(5)
    x, q = _data(3000, 16, 80, rng)
    jidx = jax_cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0)
    return x, q, jidx, _carried(jidx)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,ring", [(1, 0), (2, 0), (2, -1)])
def test_search_chunk_matches_reference_with_its_seeds(built, compute, width, ring):
    x, q, jidx, tidx = built
    k, seed = 10, 3
    sp = cagra.SearchParams(itopk_size=64, search_width=width, visited_size=ring)
    itopk, max_iter, vis_size = cagra._plan(sp, k)
    n_seeds = max(itopk, sp.num_random_samplings * itopk)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    seeds = np.array(jax.random.randint(key, (q.shape[0], n_seeds), 0, jidx.size))
    qids = np.arange(q.shape[0], dtype=np.int32)
    jd, ji = jax_cagra._search_chunk(
        jidx.data_pack, jidx.dataset_norms, jidx.graph, q, qids, jax_filters.no_filter(), key,
        k, itopk, width, max_iter, 1, vis_size, jidx.metric, getattr(jnp, compute))
    td, ti = cagra._search_chunk(
        tidx.data_pack, tidx.dataset_norms, tidx.graph, torch.from_numpy(q),
        torch.from_numpy(qids), filters.no_filter(), torch.from_numpy(seeds), k, itopk, width,
        max_iter, vis_size, tidx.metric, getattr(torch, compute))
    assert ti.dtype == torch.int32 and ti.shape == (q.shape[0], k)
    assert (ti.numpy() == np.asarray(ji)).mean() >= 0.99
    _, gti = naive_knn(q, x, k)
    assert abs(calc_recall(ti.numpy(), gti) - calc_recall(np.asarray(ji), gti)) <= 0.005
    same = ti.numpy() == np.asarray(ji)
    np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same], rtol=1e-5, atol=1e-4)


def test_filtered_search_chunk_matches_reference(built):
    x, q, jidx, tidx = built
    k, seed = 10, 4
    keep = np.random.default_rng(2).random(jidx.size) > 0.3
    sp = cagra.SearchParams(itopk_size=64)
    itopk, max_iter, vis_size = cagra._plan(sp, k)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    seeds = np.array(jax.random.randint(key, (q.shape[0], itopk), 0, jidx.size))
    qids = np.arange(q.shape[0], dtype=np.int32)
    jd, ji = jax_cagra._search_chunk(
        jidx.data_pack, jidx.dataset_norms, jidx.graph, q, qids, jax_filters.from_mask(keep), key,
        k, itopk, 1, max_iter, 1, vis_size, jidx.metric, jnp.float32)
    td, ti = cagra._search_chunk(
        tidx.data_pack, tidx.dataset_norms, tidx.graph, torch.from_numpy(q),
        torch.from_numpy(qids), filters.from_mask(torch.from_numpy(keep)),
        torch.from_numpy(seeds), k, itopk, 1, max_iter, vis_size, tidx.metric, torch.float32)
    assert (ti.numpy() == np.asarray(ji)).mean() >= 0.99
    assert keep[ti.numpy()[np.isfinite(td.numpy())]].all()


@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_search_postprocess_matches_reference(metric):
    x, q = _data(1500, 16, 40, np.random.default_rng(8))
    jidx = jax_cagra.build(x, intermediate_graph_degree=32, graph_degree=16, metric=metric, seed=0)
    tidx = _carried(jidx)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    seeds = np.array(jax.random.randint(key, (40, 64), 0, 1500))
    jd, ji = jax_cagra._search_chunk(
        jidx.data_pack, jidx.dataset_norms, jidx.graph, q, np.arange(40, dtype=np.int32),
        jax_filters.no_filter(), key, 5, 64, 1, 74, 1, 128, jidx.metric, jnp.float32)
    td, ti = cagra._search_chunk(
        tidx.data_pack, tidx.dataset_norms, tidx.graph, torch.from_numpy(q), torch.arange(40),
        filters.no_filter(), torch.from_numpy(seeds), 5, 64, 1, 74, 128, tidx.metric,
        torch.float32)
    same = ti.numpy() == np.asarray(ji)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same], rtol=1e-5, atol=1e-4)


def test_extend_matches_reference_given_its_search(built, monkeypatch):
    x, _, _, _ = built
    base, new = x[:2500], x[2500:2800]
    jidx = jax_cagra.build(base, intermediate_graph_degree=48, graph_degree=24, seed=0)
    found, search = [], jax_cagra.search

    def record(*a, **kw):
        out = search(*a, **kw)
        found.append(tuple(np.array(o) for o in out))
        return out

    monkeypatch.setattr(jax_cagra, "search", record)
    jext = jax_cagra.extend(jidx, new)
    monkeypatch.setattr(cagra, "search",
                        lambda *a, **kw: tuple(torch.from_numpy(o) for o in found[0]))
    text = cagra.extend(_carried(jidx), torch.from_numpy(new))
    assert text.size == 2800 and text.graph.dtype == torch.int32
    assert np.array_equal(text.graph.numpy(), np.asarray(jext.graph))
    assert np.array_equal(text.dataset.numpy(), np.asarray(jext.dataset))
    np.testing.assert_allclose(text.dataset_norms.numpy(), np.asarray(jext.dataset_norms),
                               rtol=1e-6)


def test_from_graph_storage_dtype_matches_reference(built):
    x, _, jidx, _ = built
    j = jax_cagra.from_graph(x, np.asarray(jidx.graph), storage_dtype=jnp.bfloat16)
    t = cagra.from_graph(x, np.asarray(jidx.graph), storage_dtype=torch.bfloat16, device="cpu")
    assert t.dataset.dtype == torch.bfloat16 and t.graph.dtype == torch.int32
    np.testing.assert_allclose(t.dataset_norms.numpy(), np.asarray(j.dataset_norms), rtol=1e-6)
    np.testing.assert_allclose(t.dataset_norms.numpy(),
                               pairwise.row_norms(torch.from_numpy(x)).numpy(), rtol=0)
    assert np.array_equal(t.dataset.float().numpy(), np.asarray(j.dataset, np.float32))


@pytest.mark.parametrize("build_algo", ["brute_force", "ivf_pq"])
def test_recall(build_algo):
    x, q = _data(5000, 32, 100)
    idx = cagra.build(x, intermediate_graph_degree=64, graph_degree=32, build_algo=build_algo,
                      seed=0, device="cpu")
    d, i = cagra.search(idx, q, 10, itopk_size=64)
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.9, build_algo


def test_itopk_improves_recall():
    x, q = _data(4000, 32, 50)
    idx = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0, device="cpu")
    _, gti = naive_knn(q, x, 10)
    r = {it: calc_recall(cagra.search(idx, q, 10, itopk_size=it)[1].numpy(), gti)
         for it in (16, 64, 128)}
    assert r[128] >= r[16] - 0.02
    assert r[128] >= 0.9, r


def test_prefilter():
    x, q = _data(4000, 16, 20)
    keep = RNG.random(4000) > 0.3
    idx = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0, device="cpu")
    d, i = cagra.search(idx, q, 10, prefilter=filters.from_mask(torch.from_numpy(keep)))
    i, d = i.numpy(), d.numpy()
    assert keep[i[np.isfinite(d)]].all()
    kept = np.where(keep)[0]
    _, gtl = naive_knn(q, x[kept], 10)
    assert calc_recall(i, kept[gtl]) >= 0.85


def test_no_duplicate_results():
    x, q = _data(3000, 16, 30)
    idx = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0, device="cpu")
    for row in cagra.search(idx, q, 10)[1].numpy():
        assert len(set(row.tolist())) == len(row), row


def test_from_graph_roundtrip():
    x, q = _data(2000, 16, 10)
    idx = cagra.build(x, intermediate_graph_degree=32, graph_degree=16, seed=0, device="cpu")
    idx2 = cagra.from_graph(x, idx.graph.numpy(), device="cpu")
    assert torch.equal(cagra.search(idx, q, 5)[1], cagra.search(idx2, q, 5)[1])


def test_extend():
    x, q = _data(5000, 16, 30)
    idx = cagra.build(x[:4000], intermediate_graph_degree=48, graph_degree=24, seed=0,
                      device="cpu")
    idx = cagra.extend(idx, x[4000:])
    assert idx.size == 5000
    _, gti = naive_knn(q, x, 10)
    assert calc_recall(cagra.search(idx, q, 10, itopk_size=96)[1].numpy(), gti) >= 0.85
    # new nodes are findable: search for them exactly
    _, i2 = cagra.search(idx, x[4500:4510], 1, itopk_size=64)
    assert (i2.numpy().ravel() == np.arange(4500, 4510)).mean() >= 0.8


def test_extend_many_rounds_no_degradation():
    x, q = _data(4000, 16, 40)
    idx = cagra.build(x[:2000], intermediate_graph_degree=48, graph_degree=24, seed=0,
                      device="cpu")
    for r in range(10):
        idx = cagra.extend(idx, x[2000 + r * 200:2000 + (r + 1) * 200])
    assert idx.size == 4000
    rebuilt = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0, device="cpu")
    _, gti = naive_knn(q, x, 10)
    r_ext = calc_recall(cagra.search(idx, q, 10, itopk_size=96)[1].numpy(), gti)
    r_reb = calc_recall(cagra.search(rebuilt, q, 10, itopk_size=96)[1].numpy(), gti)
    assert r_ext >= r_reb - 0.02, (r_ext, r_reb)


def test_guarantee_connectivity():
    blobs = []
    for c in range(4):
        center = np.zeros(16, np.float32)
        center[c] = 200.0
        blobs.append(center + RNG.standard_normal((500, 16)).astype(np.float32))
    x = np.concatenate(blobs)
    idx_off = cagra.build(x, intermediate_graph_degree=32, graph_degree=16, seed=0, device="cpu")
    assert len(np.unique(graph_core.connected_components(idx_off.graph).numpy())) > 1
    idx_on = cagra.build(x, intermediate_graph_degree=32, graph_degree=16, seed=0,
                         guarantee_connectivity=True, device="cpu")
    assert len(np.unique(graph_core.connected_components(idx_on.graph).numpy())) == 1
    _, i = cagra.search(idx_on, x[::100] + 0.01, 1, itopk_size=64)
    assert (i.numpy().ravel() == np.arange(0, 2000, 100)).mean() >= 0.9


def test_from_hnsw_params():
    p = cagra.IndexParams.from_hnsw_params(500_000, 96, 32, 200)
    assert p.graph_degree == 2 + 2 * 32 // 3
    assert p.intermediate_graph_degree == 32 + 32 * 200 // 256
    assert p.build_algo == "nn_descent"
    assert p.nn_descent_params.max_iterations == 5 + 200 // 16
    p2 = cagra.IndexParams.from_hnsw_params(5_000_000, 96, 32, 128,
                                            heuristic="same_graph_footprint")
    assert p2.graph_degree == 64 and p2.intermediate_graph_degree == 96
    assert p2.build_algo == "ivf_pq" and p2.build_n_probes > 0
    assert p2 == cagra.IndexParams(**{
        f: getattr(jax_cagra.IndexParams.from_hnsw_params(
            5_000_000, 96, 32, 128, heuristic="same_graph_footprint"), f)
        for f in ("intermediate_graph_degree", "graph_degree", "metric", "build_algo",
                  "build_n_probes")}, ivf_pq_params=p2.ivf_pq_params)
    with pytest.raises(ValueError):
        cagra.IndexParams.from_hnsw_params(1000, 8, 8, 64, heuristic="nope")


def test_from_hnsw_params_builds():
    rng = np.random.default_rng(17)
    x, q = make_blobs(rng, 3000, 24), make_blobs(rng, 32, 24)
    idx = cagra.build(x, cagra.IndexParams.from_hnsw_params(3000, 24, 12, 64), device="cpu")
    d, i = cagra.search(idx, q, 5, itopk_size=32)
    gtd, gti = naive_knn(q, x, 5)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.8


def test_visited_ring_off():
    x, q = _data(4000, 32, 50)
    idx = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0, device="cpu")
    _, gti = naive_knn(q, x, 10)
    _, i_on = cagra.search(idx, q, 10, itopk_size=64, search_width=2)
    _, i_off = cagra.search(idx, q, 10, itopk_size=64, search_width=2, visited_size=-1)
    assert calc_recall(i_off.numpy(), gti) >= calc_recall(i_on.numpy(), gti) - 0.05
    for row in i_off.numpy():
        assert len(set(row.tolist())) == len(row)


def test_search_seeds_do_not_depend_on_the_device_or_chunk(built):
    _, q, _, tidx = built
    a = cagra.search(tidx, q, 10, query_chunk=80, seed=5)
    b = cagra.search(tidx, q, 10, query_chunk=80, seed=5)
    assert torch.equal(a[1], b[1])
    s = cagra._draw_seeds(tidx.size, 80, 64, 5, 0)
    assert s.dtype == torch.int32 and s.device.type == "cpu"
    assert torch.equal(s, cagra._draw_seeds(tidx.size, 80, 64, 5, 0))
    assert not torch.equal(s, cagra._draw_seeds(tidx.size, 80, 64, 5, 80))


@pytest.mark.parametrize("part", ["compress", "pack", "merge", "build_ace", "build_iterative"])
def test_part_two_runs(built, part, tmp_path):
    """Each of CAGRA part 2's entry points gives an index that searches
    (test_torch_cagra_layouts.py holds them against the reference)."""
    x, q, _, tidx = built
    xt = torch.from_numpy(x)
    small = dict(intermediate_graph_degree=32, graph_degree=16, seed=0)
    if part == "compress":
        ix, floor = cagra.compress(tidx, vq_n_centers=32, pq_dim=8), 0.5
    elif part == "pack":
        ix, floor = cagra.pack(tidx), 0.8
    elif part == "merge":
        halves = [cagra.build(xt[:1500], **small), cagra.build(xt[1500:], **small)]
        ix, floor = cagra.merge(halves, strategy="logical"), 0.8
        assert ix.size == 3000
        d, i = ix.search(q, 10, itopk_size=64)
    elif part == "build_ace":
        ix, floor = cagra.build_ace(xt, npartitions=2, build_dir=str(tmp_path), **small), 0.8
    else:
        ix, floor = cagra.build_iterative(xt, n_rounds=2, graph_degree=16,
                                          intermediate_graph_degree=32), 0.8
    if part != "merge":
        d, i = cagra.search(ix, q, 10, itopk_size=64)
    assert i.shape == (len(q), 10) and bool(torch.isfinite(d).all())
    _, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti) >= floor
