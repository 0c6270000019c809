"""Single-linkage clustering: the port against the JAX package on the CPU.

The Borůvka forest is unique under its strict order (weight, undirected edge
id), so the port's mask must EQUAL the reference's on the same edges, also
where weights repeat. ``single_linkage`` with both packages' knn graph
replaced by one recorded graph: labels, dendrogram and sizes equal, merge
heights rtol 1e-5 (the repair edges come from each package's own exact
search). The reference test's purity holds on the port's own graph.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csg
import torch

import cuvs_tpu.neighbors.knn_graph as jax_kg
from cuvs_tpu.cluster import agglomerative as jax_agg
from cuvs_tpu_torch.cluster import agglomerative as agg
from cuvs_tpu_torch.neighbors import knn_graph as kg

torch.set_num_threads(1)


def _knn_edges(x, k):
    d = ((x[:, None, :] - x[None, :, :]) ** 2).sum(2)
    np.fill_diagonal(d, np.inf)
    nbrs = np.argsort(d, axis=1, kind="stable")[:, :k]
    w = np.take_along_axis(d, nbrs, axis=1)
    u = np.repeat(np.arange(x.shape[0], dtype=np.int32), k)
    return u, nbrs.reshape(-1).astype(np.int32), w.reshape(-1).astype(np.float32)


def _masks(u, v, w, n):
    want = np.asarray(jax_agg._boruvka_forest(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), n))
    got = agg._boruvka_forest(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(w),
                              n).numpy()
    return got, want


def test_boruvka_mask_equals_reference_and_scipy():
    """The reference test's edges (test_extras.py::test_boruvka_forest_matches_scipy_mst)."""
    rng = np.random.default_rng(3)
    n, k = 500, 8
    x = rng.standard_normal((n, 3)).astype(np.float32)
    u, v, w = _knn_edges(x, k)
    got, want = _masks(u, v, w, n)
    np.testing.assert_array_equal(got, want)
    g = sp.csr_matrix((w, (u, v)), shape=(n, n))
    g = g.maximum(g.T)
    ncomp, _ = csg.connected_components(g, directed=False)
    assert got.sum() == n - ncomp
    np.testing.assert_allclose(float(w[got].sum()), float(csg.minimum_spanning_tree(g).sum()),
                               rtol=1e-5)


@pytest.mark.parametrize("seed,levels", [(0, 3), (1, 1), (2, 7)])
def test_boruvka_mask_equals_reference_with_repeated_weights(seed, levels):
    """Weights from a few values (one value: every edge ties), duplicate
    edges and several components: the edge id decides every tie."""
    rng = np.random.default_rng(seed)
    n, m = 300, 900
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    v = np.where(u == v, (v + 1) % n, v).astype(np.int32)
    u[-20:], v[-20:] = u[:20], v[:20]  # repeated edges
    w = rng.integers(1, levels + 1, m).astype(np.float32)
    got, want = _masks(u, v, w, n)
    np.testing.assert_array_equal(got, want)


def test_boruvka_single_round_and_empty():
    u = np.array([0, 2], np.int32)
    v = np.array([1, 3], np.int32)
    w = np.array([1.0, 2.0], np.float32)
    got, want = _masks(u, v, w, 5)
    np.testing.assert_array_equal(got, want)
    assert got.all()


def _blobs(seed, n=400, scale=0.3):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0], [10, 10], [-10, 10]], np.float32)
    labels_true = rng.integers(0, 3, n)
    x = centers[labels_true] + rng.standard_normal((n, 2)).astype(np.float32) * scale
    return x, labels_true


@pytest.mark.parametrize("n_neighbors,n_clusters", [(15, 3), (4, 3), (6, 5)])
def test_single_linkage_matches_reference_on_a_shared_graph(monkeypatch, n_neighbors, n_clusters):
    """The knn graph is recorded once (the reference's) and replayed into both
    packages; with 4 neighbours it is disconnected, so the repair rounds run."""
    x, _ = _blobs(11)
    nbrs, dists = (np.array(a) for a in jax_kg.build_knn_graph(x, n_neighbors,
                                                                 metric="euclidean"))
    g = sp.csr_matrix((np.ones(nbrs.size), (np.repeat(np.arange(len(x)), n_neighbors),
                                            nbrs.reshape(-1))), shape=(len(x), len(x)))
    monkeypatch.setattr(jax_kg, "build_knn_graph", lambda *a, **kw: (nbrs, dists))
    monkeypatch.setattr(kg, "build_knn_graph",
                        lambda *a, **kw: (torch.from_numpy(nbrs), torch.from_numpy(dists)))
    want = jax_agg.single_linkage(x, n_clusters=n_clusters, n_neighbors=n_neighbors)
    got = agg.single_linkage(x, n_clusters=n_clusters, n_neighbors=n_neighbors, device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.dendrogram, want.dendrogram)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
    assert got.labels.dtype == np.int32 and got.dendrogram.shape == (len(x) - 1, 2)
    if n_neighbors == 4:
        assert csg.connected_components(g, directed=False)[0] > 1  # the repair ran


def test_single_linkage_purity_on_own_graph():
    """The reference test (test_extras.py::test_single_linkage) on the port's graph."""
    x, labels_true = _blobs(63)
    out = agg.single_linkage(x, n_clusters=3, device="cpu")
    assert out.labels.shape == (400,)
    assert len(np.unique(out.labels)) == 3
    purity = sum(Counter(out.labels[labels_true == c]).most_common(1)[0][1] for c in range(3))
    assert purity == 400
    assert out.dendrogram.shape[0] == 399
    assert (np.diff(out.distances) >= -1e-6).all()


def test_single_linkage_rejects_bad_cluster_count():
    with pytest.raises(ValueError):
        agg.single_linkage(np.zeros((4, 2), np.float32), n_clusters=5, device="cpu")
