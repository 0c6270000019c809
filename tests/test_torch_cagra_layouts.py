"""CAGRA's packed and VPQ-compressed layouts and its partitioned (ACE) and
iterative builds: the port against the JAX package on the CPU.

Tolerances: a beam search of one chunk over an index carried across, given
the reference's own seeds (cagra.py:352, :580), returns at least 99% of the
reference's (query, rank) ids, with distances to rtol 1e-5 / atol 1e-4 where
the ids agree, in float32 and bfloat16 compute. ``pack``'s int8 codes,
scale, child pieces and child norms are bit-identical. ``compress``, given
the reference's quantizer, decodes the same rows and norms to rtol 1e-6.
``build_iterative`` and ``build_ace``, given the reference's draws (its
bootstrap graph and recorded searches; its partition centres and recorded
sub-builds), build the reference's graph. The port's own builds of these
layouts are in test_torch_cagra_builds.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.cluster import kmeans_balanced as jax_kmeans
from cuvs_tpu.distance import pairwise as jax_pairwise
from cuvs_tpu.neighbors import cagra as jax_cagra
from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu.preprocessing import quantize as jax_quantize
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import cagra, filters
from cuvs_tpu_torch.preprocessing import quantize

torch.set_num_threads(1)


def _cloud(rng, n, d):
    return (rng.standard_normal((n, d)) * 2).astype(np.float32)


def _carried(j):
    return interop.cagra_index_from_numpy(np.asarray(j.dataset), np.asarray(j.dataset_norms),
                                          np.asarray(j.graph), j.metric, device="cpu")


def _carried_packed(j):
    return interop.cagra_packed_index_from_numpy(
        np.asarray(j.graph), [np.asarray(cv) for cv in j.child_vecs], np.asarray(j.child_norms),
        np.asarray(j.dataset_int8), np.asarray(j.dataset_norms), np.asarray(j.scale), j.metric,
        device="cpu")


def _carried_compressed(j):
    return interop.cagra_compressed_index_from_numpy(
        np.asarray(j.vq_centers), np.asarray(j.vq_codes), np.asarray(j.pq_codes),
        np.asarray(j.pq_codebooks), np.asarray(j.dataset_norms), np.asarray(j.graph), j.metric,
        device="cpu")


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(9)
    x, q = _cloud(rng, 3000, 32), _cloud(rng, 80, 32)
    jidx = jax_cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0)
    return x, q, jidx, _carried(jidx)


def _plan_and_seeds(jidx, nq, k, seed, **sp):
    itopk, max_iter, vis_size = cagra._plan(cagra.SearchParams(**sp), k)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    seeds = np.array(jax.random.randint(key, (nq, itopk), 0, jidx.size))
    return itopk, max_iter, vis_size, key, seeds


def _assert_parity(jd, ji, td, ti, k):
    assert ti.dtype == torch.int32 and ti.shape == (ji.shape[0], k)
    ji, jd = np.asarray(ji), np.asarray(jd)
    same = ti.numpy() == ji
    assert same.mean() >= 0.99
    np.testing.assert_allclose(td.numpy()[same], jd[same], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [1, 2])
def test_packed_search_chunk_matches_reference_with_its_seeds(built, compute, width):
    _, q, jidx, _ = built
    k = 10
    jp = jax_cagra.pack(jidx, _piece_bytes=3000 * 32 * 8)  # three pieces of 8 neighbours
    tp = _carried_packed(jp)
    itopk, max_iter, vis_size, key, seeds = _plan_and_seeds(jidx, len(q), k, 5, itopk_size=64,
                                                            search_width=width)
    qids = np.arange(len(q), dtype=np.int32)
    jd, ji = jax_cagra._search_chunk_packed(
        jp.graph, jp.child_vecs, jp.child_norms, jp.dataset_int8, jp.dataset_norms, jp.scale, q,
        qids, jax_filters.no_filter(), key, k, itopk, width, max_iter, 1, vis_size, jp.metric,
        getattr(jnp, compute))
    td, ti = cagra._search_chunk_packed(
        tp.graph, tp.child_vecs, tp.child_norms, tp.dataset_int8, tp.dataset_norms, tp.scale,
        torch.from_numpy(q), torch.from_numpy(qids), filters.no_filter(), torch.from_numpy(seeds),
        k, itopk, width, max_iter, vis_size, tp.metric, getattr(torch, compute))
    _assert_parity(jd, ji, td, ti, k)


@pytest.mark.parametrize("metric", ["inner_product", "euclidean"])
def test_packed_filtered_search_chunk_matches_reference(metric):
    rng = np.random.default_rng(10)
    x, q = _cloud(rng, 2000, 16), _cloud(rng, 40, 16)
    jidx = jax_cagra.build(x, intermediate_graph_degree=32, graph_degree=16, metric=metric,
                           seed=0)
    jp = jax_cagra.pack(jidx)
    tp = _carried_packed(jp)
    keep = rng.random(2000) > 0.3
    k = 10
    itopk, max_iter, vis_size, key, seeds = _plan_and_seeds(jidx, len(q), k, 2, itopk_size=64)
    qids = np.arange(len(q), dtype=np.int32)
    jd, ji = jax_cagra._search_chunk_packed(
        jp.graph, jp.child_vecs, jp.child_norms, jp.dataset_int8, jp.dataset_norms, jp.scale, q,
        qids, jax_filters.from_mask(keep), key, k, itopk, 1, max_iter, 1, vis_size, jp.metric,
        jnp.float32)
    td, ti = cagra._search_chunk_packed(
        tp.graph, tp.child_vecs, tp.child_norms, tp.dataset_int8, tp.dataset_norms, tp.scale,
        torch.from_numpy(q), torch.from_numpy(qids), filters.from_mask(keep, device="cpu"),
        torch.from_numpy(seeds), k, itopk, 1, max_iter, vis_size, tp.metric, torch.float32)
    _assert_parity(jd, ji, td, ti, k)
    assert keep[ti.numpy()[np.isfinite(td.numpy())]].all()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_compressed_search_chunk_matches_reference_with_its_seeds(built, compute):
    _, q, jidx, _ = built
    k = 10
    jc = jax_cagra.compress(jidx, vq_n_centers=32, pq_dim=8, seed=0)
    tc = _carried_compressed(jc)
    itopk, max_iter, vis_size, key, seeds = _plan_and_seeds(jidx, len(q), k, 7, itopk_size=64,
                                                            search_width=2)
    qids = np.arange(len(q), dtype=np.int32)
    jd, ji = jax_cagra._search_chunk(
        jc.data_pack, jc.dataset_norms, jc.graph, q, qids, jax_filters.no_filter(), key, k, itopk,
        2, max_iter, 1, vis_size, jc.metric, getattr(jnp, compute))
    td, ti = cagra._search_chunk(
        tc.data_pack, tc.dataset_norms, tc.graph, torch.from_numpy(q), torch.from_numpy(qids),
        filters.no_filter(), torch.from_numpy(seeds), k, itopk, 2, max_iter, vis_size, tc.metric,
        getattr(torch, compute))
    _assert_parity(jd, ji, td, ti, k)


@pytest.mark.parametrize("blk,piece_bytes,pieces,rows", [
    (0, 2 << 30, 1, 3000),  # one piece, blocks that divide n
    (700, 2 << 30, 1, 3500),  # five blocks: 500 padded tail rows of row 0's vector
    (0, 3000 * 32 * 8, 3, 3000),  # three pieces of 8 neighbours
    (1000, 3000 * 32 * 5, 5, 3000),  # 5, 5, 5, 5, 4: an uneven last piece
])
def test_pack_matches_reference_bit_for_bit(built, blk, piece_bytes, pieces, rows):
    _, _, jidx, tidx = built
    jp = jax_cagra.pack(jidx, _blk=blk, _piece_bytes=piece_bytes)
    tp = cagra.pack(tidx, _blk=blk, _piece_bytes=piece_bytes)
    assert len(tp.child_vecs) == pieces and tp.child_vecs[0].shape[0] == rows
    assert tp.scale.dtype == torch.float32 and tp.scale.shape == ()
    assert np.array_equal(tp.scale.numpy(), np.asarray(jp.scale))
    assert np.array_equal(tp.dataset_int8.numpy(), np.asarray(jp.dataset_int8))
    assert np.array_equal(tp.child_norms.numpy(), np.asarray(jp.child_norms))
    for a, b in zip(tp.child_vecs, jp.child_vecs, strict=True):
        assert a.dtype == torch.int8 and np.array_equal(a.numpy(), np.asarray(b))


def test_compress_matches_reference_given_its_quantizer(built):
    _, _, jidx, tidx = built
    vpq = jax_quantize.vpq_train(jidx.dataset, vq_n_centers=32, pq_dim=8, seed=0)
    jc = jax_cagra.compress(jidx, vq_n_centers=32, pq_dim=8, seed=0)  # the same quantizer
    tvpq = quantize.VPQQuantizer(
        vq_centers=torch.from_numpy(np.array(vpq.vq_centers)),
        pq=quantize.PQQuantizer(codebooks=torch.from_numpy(np.array(vpq.pq.codebooks)),
                                dim=vpq.pq.dim))
    tc = cagra._compress_with(tidx, tvpq)
    assert tc.vq_codes.dtype == torch.int32 and tc.pq_codes.dtype == torch.uint8
    assert np.array_equal(tc.vq_codes.numpy(), np.asarray(jc.vq_codes))
    assert np.array_equal(tc.pq_codes.numpy(), np.asarray(jc.pq_codes))
    ids = np.arange(jidx.size)
    np.testing.assert_allclose(cagra._decode_rows(tc.data_pack, torch.from_numpy(ids)).numpy(),
                               np.asarray(jax_cagra._decode_rows(jc.data_pack, ids)), rtol=1e-6)
    np.testing.assert_allclose(tc.dataset_norms.numpy(), np.asarray(jc.dataset_norms), rtol=1e-6)


def _recording(monkeypatch, module, name, found):
    fn = getattr(module, name)

    def record(*a, **kw):
        out = fn(*a, **kw)
        found.append(out)
        return out

    monkeypatch.setattr(module, name, record)


def _replaying(monkeypatch, module, name, outs):
    it = iter(outs)
    monkeypatch.setattr(module, name, lambda *a, **kw: next(it))


def test_build_iterative_matches_reference_given_its_draws(monkeypatch):
    rng = np.random.default_rng(3)
    x = _cloud(rng, 1200, 16)
    ideg, gdeg, rounds, seed = 24, 12, 2, 4
    found = []
    _recording(monkeypatch, jax_cagra, "search", found)
    j = jax_cagra.build_iterative(x, graph_degree=gdeg, intermediate_graph_degree=ideg,
                                  n_rounds=rounds, seed=seed)
    assert len(found) == rounds
    boot = np.array(jax.random.randint(jax.random.PRNGKey(seed), (1200, gdeg), 0, 1200))
    _replaying(monkeypatch, cagra, "search",
               [tuple(torch.from_numpy(np.array(o)) for o in out) for out in found])
    t = cagra._iterate(torch.from_numpy(x), torch.from_numpy(boot.astype(np.int32)), ideg, rounds,
                       "sqeuclidean", seed)
    assert t.graph.dtype == torch.int32
    assert np.array_equal(t.graph.numpy(), np.asarray(j.graph))


def test_build_iterative_draws_its_bootstrap_on_the_host(monkeypatch):
    x = torch.from_numpy(_cloud(np.random.default_rng(4), 500, 8))
    boots = []
    monkeypatch.setattr(cagra, "_iterate", lambda x, g, *a: boots.append(g))
    cagra.build_iterative(x, graph_degree=8, intermediate_graph_degree=16, seed=3)
    cagra.build_iterative(x, graph_degree=8, intermediate_graph_degree=16, seed=3)
    a, b = boots
    assert a.device.type == "cpu" and a.dtype == torch.int32 and a.shape == (500, 8)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 500


def test_build_ace_matches_reference_given_its_partitions(monkeypatch, tmp_path):
    rng = np.random.default_rng(6)
    x = _cloud(rng, 2400, 16)
    kw = dict(npartitions=3, overlap=2, intermediate_graph_degree=24, graph_degree=12, seed=0)
    centers, subs = [], []
    _recording(monkeypatch, jax_kmeans, "fit", centers)
    _recording(monkeypatch, jax_cagra, "build", subs)
    j = jax_cagra.build_ace(x, **kw)
    assert len(centers) == 1 and len(subs) == 3
    c = np.asarray(centers[0])
    ref_ranks = np.argsort(np.asarray(jax_pairwise.pairwise_distance(x, c)), axis=1)[:, :2]
    xt = torch.from_numpy(x)
    ranks = cagra._ace_ranks(xt, torch.from_numpy(c), 2)
    assert np.array_equal(ranks, ref_ranks)
    _replaying(monkeypatch, cagra, "build",
               [cagra.Index(dataset=xt[:1], dataset_norms=xt[:1, 0],
                            graph=torch.from_numpy(np.array(s.graph)), metric=s.metric)
                for s in subs])
    params = cagra.AceParams(build_dir=str(tmp_path), **kw)
    graph = cagra._ace_assemble(xt, ranks, 3, params)
    assert np.array_equal(np.asarray(graph), np.asarray(j.graph))
    assert np.array_equal(np.load(os.path.join(str(tmp_path), "ace_graph.npy")),
                          np.asarray(j.graph))
