"""CAGRA's packed and VPQ-compressed layouts and its partitioned (ACE) and
iterative builds: the port's own builds on the CPU, held to
tests/test_cagra.py's floors (its own random draws differ from the
reference's; test_torch_cagra_layouts.py holds the functions against the
reference given the reference's draws)."""

import os

import numpy as np
import pytest
import torch

from cuvs_tpu_torch.neighbors import cagra, filters, refine
from cuvs_tpu_torch.utils import serialize
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)


def _cloud(rng, n, d):
    return (rng.standard_normal((n, d)) * 2).astype(np.float32)


def _data(n, dim, nq, seed):
    rng = np.random.default_rng(seed)
    return _cloud(rng, n, dim), _cloud(rng, nq, dim)


def test_ace_build(tmp_path):
    x, q = _data(6000, 16, 30, 21)
    idx = cagra.build_ace(x, npartitions=3, intermediate_graph_degree=48, graph_degree=24,
                          build_dir=str(tmp_path), seed=0, device="cpu")
    assert idx.size == 6000 and idx.graph_degree == 24
    assert os.path.exists(os.path.join(str(tmp_path), "ace_graph.npy"))
    _, gti = naive_knn(q, x, 10)
    _, i = cagra.search(idx, q, 10, itopk_size=96)
    assert calc_recall(i.numpy(), gti) >= 0.8


def test_vpq_compressed_search():
    x, q = _data(6000, 32, 40, 22)
    idx = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0, device="cpu")
    comp = cagra.compress(idx, vq_n_centers=64, pq_dim=16, seed=0)
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    assert nbytes(comp.vq_codes) + nbytes(comp.pq_codes) < nbytes(idx.dataset) / 4
    _, gti = naive_knn(q, x, 10)
    _, i = cagra.search(comp, q, 10, itopk_size=96)
    assert calc_recall(i.numpy(), gti) >= 0.7
    _, cand = cagra.search(comp, q, 30, itopk_size=96)
    _, ri = refine.refine(x, q, cand, 10, device="cpu")
    assert calc_recall(ri.numpy(), gti) >= 0.85


def test_iterative_build():
    x, q = _data(4000, 16, 30, 23)
    idx = cagra.build_iterative(x, graph_degree=16, intermediate_graph_degree=32, n_rounds=3,
                                seed=0, device="cpu")
    _, gti = naive_knn(q, x, 10)
    _, i = cagra.search(idx, q, 10, itopk_size=96)
    assert calc_recall(i.numpy(), gti) >= 0.8


def test_packed_search_parity():
    rng = np.random.default_rng(11)
    # 8,000 rows where the reference test takes 15,000: the port's exact knn
    # graph sorts whole rows on one CPU thread
    x, q = make_blobs(rng, 8000, 48, n_centers=20), make_blobs(rng, 128, 48, n_centers=20)
    _, gti = naive_knn(q, x, 10)
    ix = cagra.build(x, intermediate_graph_degree=64, graph_degree=32, device="cpu")
    _, i0 = cagra.search(ix, q, 10, itopk_size=64)
    pk = cagra.pack(ix)
    d1, i1 = cagra.search(pk, q, 10, itopk_size=64)
    assert calc_recall(i1.numpy(), gti) >= calc_recall(i0.numpy(), gti) - 0.05
    true = ((q[:, None, :] - x[i1.numpy()]) ** 2).sum(-1)
    assert np.median(np.abs(d1.numpy() - true) / np.maximum(true, 1e-6)) < 0.02


def test_pack_padded_tail():
    rng = np.random.default_rng(13)
    x, q = make_blobs(rng, 5000, 32, n_centers=10), make_blobs(rng, 64, 32, n_centers=10)
    ix = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, device="cpu")
    pk0, pk1 = cagra.pack(ix), cagra.pack(ix, _blk=1500)  # 4 blocks: 1000 padded tail rows
    assert pk0.child_vecs[0].shape[0] == 5000 and pk1.child_vecs[0].shape[0] == 6000
    assert pk1.size == 5000
    (d0, i0), (d1, i1) = cagra.search(pk0, q, 10, itopk_size=64), cagra.search(pk1, q, 10,
                                                                                itopk_size=64)
    assert torch.equal(i0, i1) and torch.allclose(d0, d1)


def test_pack_deg_axis_pieces(tmp_path):
    rng = np.random.default_rng(14)
    x, q = make_blobs(rng, 5000, 32, n_centers=10), make_blobs(rng, 64, 32, n_centers=10)
    ix = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, device="cpu")
    pk0, pk3 = cagra.pack(ix), cagra.pack(ix, _piece_bytes=5000 * 32 * 8)  # 3 pieces of 8
    assert len(pk3.child_vecs) == 3 and sum(cv.shape[1] for cv in pk3.child_vecs) == 24
    (d0, i0), (d3, i3) = cagra.search(pk0, q, 10, itopk_size=64), cagra.search(pk3, q, 10,
                                                                                itopk_size=64)
    assert torch.equal(i0, i3) and torch.allclose(d0, d3)
    path = str(tmp_path / "packed.npz")
    serialize.save(path, pk3)
    back = serialize.load(path, device="cpu")
    assert len(back.child_vecs) == 3
    assert torch.equal(cagra.search(back, q, 10, itopk_size=64)[1], i3)


def test_packed_search_filtered():
    rng = np.random.default_rng(12)
    x, q = make_blobs(rng, 8000, 32, n_centers=10), make_blobs(rng, 64, 32, n_centers=10)
    pk = cagra.pack(cagra.build(x, intermediate_graph_degree=32, graph_degree=16, device="cpu"))
    removed = np.zeros(8000, bool)
    removed[::2] = True
    d, i = cagra.search(pk, q, 10, itopk_size=64,
                        prefilter=filters.from_mask(~removed, device="cpu"))
    returned = np.isfinite(d.numpy())
    assert not np.any(i.numpy()[returned] % 2 == 0) and returned.any()


def test_pack_rejects_other_metrics():
    x = _cloud(np.random.default_rng(15), 300, 8)
    ix = cagra.build(x, intermediate_graph_degree=16, graph_degree=8, metric="cosine",
                     device="cpu")
    with pytest.raises(ValueError, match="L2/IP"):
        cagra.pack(ix)
