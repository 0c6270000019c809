"""Lloyd k-means with k-means++ seeding: the port against the JAX package on
the CPU, and the reference's own k-means tests on the port.

From the same initial centres both Lloyd loops are deterministic: centres to
rtol 1e-4, labels equal except where a row sits within rtol 1e-4 of two
centres, inertia to rtol 1e-5 and the same iteration count. k-means++ draws
from another generator than ``jax.random``; fed the reference's picks it
selects the reference's rows.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.cluster import kmeans as jax_kmeans
from cuvs_tpu_torch.cluster import kmeans
from tests.utils import make_blobs

torch.set_num_threads(1)

RNG = np.random.default_rng(5)


def _blob_data(n=2000, dim=16, n_centers=8, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, dim)) * 10.0
    labels = rng.integers(0, n_centers, n)
    x = centers[labels] + rng.standard_normal((n, dim)) * 0.5
    return x.astype(np.float32), labels, centers


def _labels_equal_but_near_ties(x, centers, la, lb, rtol=1e-4):
    la, lb = np.asarray(la), np.asarray(lb)
    diff = np.flatnonzero(la != lb)
    d = ((x[diff, None, :].astype(np.float64) - centers[None].astype(np.float64)) ** 2).sum(-1)
    da, db = d[np.arange(len(diff)), la[diff]], d[np.arange(len(diff)), lb[diff]]
    assert np.all(np.abs(da - db) <= rtol * np.maximum(da, db)), diff
    assert len(diff) <= 0.001 * len(la) + 1


@pytest.mark.parametrize("n,dim,k,seed", [(2000, 16, 8, 5), (3000, 24, 20, 6), (1500, 8, 3, 7)])
def test_lloyd_matches_reference_from_the_same_centres(n, dim, k, seed):
    """One cluster per blob. Where clusters split a blob, rows sit at
    near-ties that the two matmuls' rounding sends either way, and the two
    loops then follow other trajectories (both valid)."""
    x, labels, _ = _blob_data(n, dim, k, seed)
    init = x[[int(np.flatnonzero(labels == c)[0]) for c in range(k)]]
    jc, jl, ji, jn = jax_kmeans.fit(x, n_clusters=k, init_centers=init)
    tc, tl, ti, tn = kmeans.fit(x, n_clusters=k, init_centers=init, device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    _labels_equal_but_near_ties(x, tc.numpy(), tl.numpy(), jl)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    assert tn == int(jn)


def test_weighted_lloyd_matches_reference():
    x, _, _ = _blob_data(400, 4, 2)
    w = np.ones(400, np.float32)
    w[:200] = 100.0
    init = x[[3, 250, 399]]
    jc, jl, ji, jn = jax_kmeans.fit(x, n_clusters=3, sample_weights=w, init_centers=init)
    tc, tl, ti, tn = kmeans.fit(x, n_clusters=3, sample_weights=w, init_centers=init,
                                device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    assert tn == int(jn)


def test_empty_cluster_keeps_its_centre():
    x = np.zeros((50, 4), np.float32)
    x[25:] = 1.0
    init = np.array([[0, 0, 0, 0], [1, 1, 1, 1], [50, 50, 50, 50]], np.float32)
    tc, tl, _, _ = kmeans.fit(x, n_clusters=3, init_centers=init, device="cpu")
    jc, _, _, _ = jax_kmeans.fit(x, n_clusters=3, init_centers=init)
    np.testing.assert_array_equal(tc.numpy()[2], init[2])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)


def test_predict_transform_and_cost_match_reference():
    x, _, _ = _blob_data(600, 8, 4)
    centers = x[[0, 100, 200, 300, 400]]
    _labels_equal_but_near_ties(x, centers, kmeans.predict(x, centers, device="cpu").numpy(),
                                jax_kmeans.predict(x, centers))
    # squared: a root near 0 magnifies the expanded form's rounding
    np.testing.assert_allclose(kmeans.transform(x, centers, device="cpu").numpy() ** 2,
                               np.asarray(jax_kmeans.transform(x, centers)) ** 2, rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(float(kmeans.cluster_cost(x, centers, device="cpu")),
                               float(jax_kmeans.cluster_cost(x, centers)), rtol=1e-5)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_kmeans_pp_given_the_reference_picks_selects_its_rows(k):
    """The reference's draws cannot be reproduced; its picks are read back
    from the rows it selected and fed to the port."""
    x = make_blobs(np.random.default_rng(k), 500, 8)
    ref = np.asarray(jax_kmeans._kmeans_pp_init(jax.random.PRNGKey(3), jnp.asarray(x), k))
    picks = [int(np.flatnonzero((x == row).all(1))[0]) for row in ref]
    got = kmeans._kmeans_pp_init(None, torch.from_numpy(x), k, picks=picks)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kmeans_pp_draws_distinct_rows_far_apart():
    """Every centre is a row; with blobs far apart every blob gets one."""
    x, labels, _ = _blob_data(2000, 16, 8)
    xt = torch.from_numpy(x)
    for seed in range(3):
        c = kmeans._kmeans_pp_init(kmeans._generator(seed, "cpu"), xt, 8)
        rows = [int(np.flatnonzero((x == r).all(1))[0]) for r in c.numpy()]
        assert len(set(labels[rows])) == 8


def test_fit_recovers_blobs():
    """tests/test_kmeans.py::test_fit_recovers_blobs on the port."""
    x, true_labels, _ = _blob_data()
    centers, labels, inertia, n_iter = kmeans.fit(x, n_clusters=8, seed=1, device="cpu")
    labels = labels.numpy()
    purity = sum(Counter(labels[true_labels == c]).most_common(1)[0][1] for c in range(8))
    assert purity / len(labels) > 0.95
    assert float(inertia) < 0.6 * 16 * len(labels)


def test_predict_matches_fit_labels():
    x, _, _ = _blob_data(500, 8, 4)
    centers, labels, _, _ = kmeans.fit(x, n_clusters=4, seed=2, device="cpu")
    np.testing.assert_array_equal(kmeans.predict(x, centers, device="cpu").numpy(), labels.numpy())
    lab2, cent2 = kmeans.fit_predict(x, n_clusters=4, seed=2, device="cpu")
    assert torch.equal(lab2, labels) and torch.equal(cent2, centers)


def test_transform_shape_and_cost():
    x, _, _ = _blob_data(300, 8, 4)
    centers, _, inertia, _ = kmeans.fit(x, n_clusters=4, seed=0, device="cpu")
    t = kmeans.transform(x, centers, device="cpu").numpy()
    assert t.shape == (300, 4)
    cost = float(kmeans.cluster_cost(x, centers, device="cpu"))
    np.testing.assert_allclose(cost, float(inertia), rtol=1e-4)
    np.testing.assert_allclose((t.min(1) ** 2).sum(), cost, rtol=1e-3)


def test_weighted_fit():
    x, _, _ = _blob_data(400, 4, 2)
    w = np.ones(400, np.float32)
    w[:200] = 100.0
    centers, _, _, _ = kmeans.fit(x, n_clusters=2, sample_weights=w, seed=0, device="cpu")
    assert torch.isfinite(centers).all()


def test_convergence_iterations():
    x, _, _ = _blob_data(1000, 8, 4)
    _, _, _, n_iter = kmeans.fit(x, n_clusters=4, max_iter=300, tol=1e-4, seed=0, device="cpu")
    assert 2 <= n_iter < 100


def test_random_init_picks_distinct_rows():
    x, _, _ = _blob_data(300, 8, 4)
    params = kmeans.KMeansParams(n_clusters=6, init="random", max_iter=1, seed=4)
    c0 = kmeans._initial_centers(kmeans._generator(4, "cpu"), torch.from_numpy(x), params,
                                 "random", None)
    assert len({tuple(r) for r in c0.numpy()}) == 6
    assert kmeans.fit(x, params, device="cpu")[0].shape == (6, 8)


def test_find_k_matches_reference():
    """Both packages binary-search the elbow on the reference's blob test;
    their k-means++ draws differ, the elbow they find does not."""
    x, _, _ = _blob_data(1000, 8, 4)
    best_k, centers, inertia = kmeans.find_k(x, kmax=16, kmin=2, device="cpu")
    ref_k, _, _ = jax_kmeans.find_k(x, kmax=16, kmin=2)
    assert 3 <= best_k <= 16
    assert best_k == ref_k
    assert centers.shape == (best_k, 8) and float(inertia) > 0
