"""Vamana: the port against the JAX package on the CPU, and the port's own
build against exact k-NN (tests/test_graph_family.py's vamana tests).

``_robust_prune`` keeps the reference's ids on the same inputs; ``build``,
given the reference's recorded prefix searches, builds the reference's graph
and medoid (the reverse-edge pass is host numpy in both); DiskANN files are
byte-identical for the same index, and each package reads the other's.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import cagra as jax_cagra
from cuvs_tpu.neighbors import vamana as jax_vamana
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import cagra, vamana
from tests.utils import calc_recall, naive_knn

torch.set_num_threads(1)


def _cloud(rng, n, d):
    return (rng.standard_normal((n, d)) * 2).astype(np.float32)


def _carried(j):
    return interop.vamana_index_from_numpy(j.dataset, j.graph, j.medoid, j.metric, device="cpu")


@pytest.fixture(scope="module")
def recorded():
    """The reference's build of 1,500 rows and the prefix searches it made."""
    x = _cloud(np.random.default_rng(3), 1500, 16)
    found, search = [], jax_cagra.search

    def record(*a, **kw):
        out = search(*a, **kw)
        found.append(tuple(np.array(o) for o in out))
        return out

    jax_cagra.search = record
    try:
        j = jax_vamana.build(x, graph_degree=16, visited_size=32, seed=0)
    finally:
        jax_cagra.search = search
    return x, j, found


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_robust_prune_matches_reference(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    B, C, d, R = 60, 20, 16, 16  # at most 15 valid candidates: every row ends in -1
    vecs = rng.standard_normal((B, C, d)).astype(np.float32)
    ids = rng.integers(0, 5000, (B, C)).astype(np.int32)
    dist = np.sort(rng.uniform(0.5, 20.0, (B, C)).astype(np.float32), axis=1)
    dist[:, -5:] = np.inf  # unfilled candidate slots
    ids[::7, 3] = -1
    pts = rng.standard_normal((B, d)).astype(np.float32)
    ref = np.asarray(jax_vamana._robust_prune(jnp.asarray(ids), jnp.asarray(dist), pts,
                                              jnp.asarray(vecs), alpha, R))
    got = vamana._robust_prune(torch.from_numpy(ids), torch.from_numpy(dist),
                               torch.from_numpy(pts), torch.from_numpy(vecs), alpha, R)
    assert got.dtype == torch.int32 and got.shape == (B, R)
    assert np.array_equal(got.numpy(), ref)
    assert (ref == -1).any() and (ref >= 0).any()


def test_build_matches_reference_given_its_searches(recorded, monkeypatch):
    x, j, found = recorded
    outs = iter(found)
    monkeypatch.setattr(cagra, "search", lambda *a, **kw: tuple(
        torch.from_numpy(o) for o in next(outs)))
    t = vamana.build(x, graph_degree=16, visited_size=32, seed=0, device="cpu")
    assert next(outs, None) is None  # as many prefix searches as the reference
    assert t.medoid == j.medoid and t.graph.dtype == torch.int32
    assert np.array_equal(t.graph.numpy(), j.graph)


def test_diskann_files_match_reference_bytes(recorded, tmp_path):
    x, j, _ = recorded
    ref, own = str(tmp_path / "ref.diskann"), str(tmp_path / "own.diskann")
    jax_vamana.serialize(j, ref)
    vamana.serialize(_carried(j), own)
    assert filecmp.cmp(ref, own, shallow=False)
    back = vamana.deserialize(ref, x, device="cpu")
    assert back.medoid == j.medoid and np.array_equal(back.graph.numpy(), j.graph)
    jback = jax_vamana.deserialize(own, x)
    assert jback.medoid == j.medoid and np.array_equal(jback.graph, j.graph)


def test_diskann_file_of_uneven_degrees_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    graph = rng.integers(0, 300, (300, 10)).astype(np.int32)
    graph[np.arange(10)[None, :] >= rng.integers(0, 11, 300)[:, None]] = -1  # degrees 0..10
    x = _cloud(rng, 300, 4)
    j = jax_vamana.Index(dataset=x, graph=graph, medoid=17)
    ref, own = str(tmp_path / "ref.diskann"), str(tmp_path / "own.diskann")
    jax_vamana.serialize(j, ref)
    vamana.serialize(_carried(j), own)
    assert filecmp.cmp(ref, own, shallow=False)
    assert np.array_equal(vamana.deserialize(own, x, device="cpu").graph.numpy(),
                          jax_vamana.deserialize(ref, x).graph)


def test_search_is_cagra_search_over_the_graph(recorded):
    x, j, _ = recorded
    t = _carried(j)
    q = torch.from_numpy(_cloud(np.random.default_rng(6), 20, 16))
    d, i = vamana.search(t, q, 5, itopk_size=32, seed=2)
    ix = cagra.from_graph(t.dataset, torch.where(t.graph >= 0, t.graph, 0))
    d2, i2 = cagra.search(ix, q, 5, itopk_size=32, seed=2)
    assert torch.equal(i, i2) and torch.equal(d, d2)


# --- the port's own build, held to tests/test_graph_family.py's floors ---


def test_vamana_build_and_search():
    rng = np.random.default_rng(83)
    x, q = _cloud(rng, 3000, 16), _cloud(rng, 30, 16)
    idx = vamana.build(x, graph_degree=24, visited_size=48, seed=0, device="cpu")
    assert idx.graph.shape == (3000, 24)
    g = idx.graph
    assert bool(((g >= -1) & (g < 3000)).all())
    assert not bool((g == torch.arange(3000)[:, None]).any())
    d, i = vamana.search(idx, q, 10, itopk_size=64)
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.8


def test_vamana_serialize_roundtrip(tmp_path):
    x = _cloud(np.random.default_rng(84), 500, 8)
    idx = vamana.build(x, graph_degree=12, visited_size=24, seed=0, device="cpu")
    p = str(tmp_path / "graph.diskann")
    vamana.serialize(idx, p)
    idx2 = vamana.deserialize(p, x, device="cpu")
    assert idx2.medoid == idx.medoid
    valid = idx.graph >= 0
    assert torch.equal(idx.graph[valid], idx2.graph[:, :idx.graph.shape[1]][valid])


def test_vamana_rejects_corrupt_file(tmp_path):
    p = tmp_path / "bad.diskann"
    p.write_bytes(b"\x99" * 64)
    with pytest.raises(ValueError, match="corrupt"):
        vamana.deserialize(str(p), np.zeros((4, 2), np.float32), device="cpu")
