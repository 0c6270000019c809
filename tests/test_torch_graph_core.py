"""CAGRA's graph optimization: the port against the JAX package on the same
seeded graphs, on the CPU. Every function is deterministic, so every result
must be exactly equal: detour counts (at several chunk sizes), the prune,
the reverse graph, the merge, ``optimize``, the component labels and the
connectivity augmentation."""

import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import graph_core as jax_gc
from cuvs_tpu.neighbors import knn_graph as jax_knn
from cuvs_tpu_torch.neighbors import graph_core

torch.set_num_threads(1)

RNG = np.random.default_rng(61)


def _cloud(n, d, rng=RNG):
    return (rng.standard_normal((n, d)) * 2).astype(np.float32)


@pytest.fixture(scope="module")
def knn():
    """A rank-sorted exact knn graph [2000, 32] from the reference."""
    x = _cloud(2000, 16)
    return x, np.array(jax_knn.build_knn_graph(x, 32, algo="brute_force")[0])


def _random_graph(n, K, seed):
    """Rows of K distinct non-self ids in random order."""
    rng = np.random.default_rng(seed)
    g = np.stack([rng.choice(np.delete(np.arange(n), i), K, replace=False) for i in range(n)])
    return g.astype(np.int32)


@pytest.mark.parametrize("chunk", [0, 8, 37, 5000])
def test_detour_counts_match_reference(knn, chunk):
    _, g = knn
    want = np.asarray(jax_gc._detour_counts(g, chunk=64))
    got = graph_core._detour_counts(torch.from_numpy(g), chunk=chunk)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_detour_counts_random_graph_match_reference():
    g = _random_graph(500, 24, 1)
    assert np.array_equal(graph_core._detour_counts(torch.from_numpy(g)).numpy(),
                          np.asarray(jax_gc._detour_counts(g)))


def test_detour_counts_small():
    # node 0 -> [1, 2]; node 1 -> [2, 3]: edge 0->2 has a detour through 1
    g = np.array([[1, 2], [2, 3], [3, 0], [0, 1]], np.int32)
    counts = graph_core._detour_counts(torch.from_numpy(g), chunk=4).numpy()
    assert counts[0, 0] == 0 and counts[0, 1] == 1


def test_prune_reverse_merge_match_reference(knn):
    _, g = knn
    jc = np.array(jax_gc._detour_counts(g))
    jf = np.array(jax_gc._prune_by_detour(g, jc, 16))
    f = graph_core._prune_by_detour(torch.from_numpy(g), torch.from_numpy(jc), 16)
    assert np.array_equal(f.numpy(), jf)
    for rev_degree in (16, 5):
        jr, jv = jax_gc._reverse_graph(jf, rev_degree)
        r, v = graph_core._reverse_graph(f, rev_degree)
        assert r.dtype == torch.int32
        assert np.array_equal(r.numpy(), np.asarray(jr)) and np.array_equal(v.numpy(),
                                                                           np.asarray(jv))
        for out_degree in (16, 12):
            jm = np.asarray(jax_gc._merge_fwd_rev(jf, jr, jv, out_degree))
            assert np.array_equal(graph_core._merge_fwd_rev(f, r, v, out_degree).numpy(), jm)


@pytest.mark.parametrize("source", ["knn", "random"])
def test_optimize_matches_reference(knn, source):
    g = knn[1] if source == "knn" else _random_graph(800, 20, 2)
    out = graph_core.optimize(torch.from_numpy(g), 12, device="cpu")
    assert np.array_equal(out.numpy(), np.asarray(jax_gc.optimize(g, 12)))


def test_optimize_shapes_and_validity(knn):
    _, g = knn
    out = graph_core.optimize(g, 16, device="cpu").numpy()
    assert out.shape == (2000, 16)
    assert (out >= 0).all() and (out < 2000).all()
    assert not (out == np.arange(2000)[:, None]).any(), "self edges"
    assert all(len(set(row)) == 16 for row in out)
    with pytest.raises(ValueError):
        graph_core.optimize(g, 33, device="cpu")


def _islands(n_blobs=4, per=300, d=16, seed=5):
    rng = np.random.default_rng(seed)
    blobs = []
    for c in range(n_blobs):
        center = np.zeros(d, np.float32)
        center[c] = 200.0
        blobs.append(center + rng.standard_normal((per, d)).astype(np.float32))
    return np.concatenate(blobs)


def test_connected_components_match_reference(knn):
    x = _islands()
    g = np.asarray(jax_gc.optimize(jax_knn.build_knn_graph(x, 24, algo="brute_force")[0], 12))
    lab = graph_core.connected_components(torch.from_numpy(g))
    want = np.asarray(jax_gc.connected_components(g))
    assert lab.dtype == torch.int32 and np.array_equal(lab.numpy(), want)
    assert len(np.unique(want)) > 1  # the islands are not connected
    one = graph_core.connected_components(torch.from_numpy(knn[1])).numpy()
    assert np.array_equal(one, np.asarray(jax_gc.connected_components(knn[1])))


@pytest.mark.parametrize("with_dataset", [False, True])
def test_augment_connectivity_matches_reference(with_dataset):
    x = _islands()
    g = np.asarray(jax_gc.optimize(jax_knn.build_knn_graph(x, 24, algo="brute_force")[0], 12))
    want = np.asarray(jax_gc.augment_connectivity(g, dataset=x if with_dataset else None))
    got = graph_core.augment_connectivity(torch.from_numpy(g),
                                          dataset=torch.from_numpy(x) if with_dataset else None)
    assert np.array_equal(got.numpy(), want)
    assert len(np.unique(graph_core.connected_components(got).numpy())) == 1
