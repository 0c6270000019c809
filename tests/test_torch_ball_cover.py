"""Ball cover, the epsilon neighbourhood and cross-component edges: the port
against the JAX package on the CPU.

Ball cover: the reference's fitted index carried across
(``interop.ball_cover_index_from_numpy``), so both packages search the same
cells; distances rtol 1e-5, ids equal except at tied distances. The port's
own build is held to the reference test's recall (>= 0.999 against
``naive_knn``) and its distance bound (rtol 1e-3). Adjacencies are equal
except where a distance lies within 1e-5 (relative) of eps, where the two
packages' rounding may put it on either side. Cross-component edges: equal
rows, distances rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import ball_cover as jax_bc
from cuvs_tpu.neighbors import cross_component as jax_cc
from cuvs_tpu.neighbors import epsilon_neighborhood as jax_eps
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import ball_cover, cross_component, epsilon_neighborhood
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)


def _carried(j):
    inner = j.inner
    return interop.ball_cover_index_from_numpy(
        inner.centers, inner.center_norms, inner.sorted_data, inner.sorted_norms,
        inner.lists.offsets, inner.lists.sizes, inner.lists.ids, inner.lists.labels,
        inner.q_scale, inner.metric, inner.window, inner.n_rows, j.radii, device="cpu")


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(63)
    x = make_blobs(rng, 4000, 16)
    q = make_blobs(rng, 30, 16)
    j = jax_bc.build(x, seed=0)
    return x, q, j, _carried(j)


def _exact_distances(q, x, ids):
    """float64 sqrt-L2 distances of each query to the ids it got."""
    diff = q[:, None, :].astype(np.float64) - x[np.asarray(ids)].astype(np.float64)
    return np.sqrt((diff ** 2).sum(-1))


@pytest.mark.parametrize("two_pass", [True, False])
def test_knn_query_matches_reference(fitted, two_pass):
    x, q, j, t = fitted
    jd, ji = jax_bc.knn_query(j, q, 10, two_pass=two_pass)
    td, ti = ball_cover.knn_query(t, q, 10, two_pass=two_pass)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd))
    assert ti.dtype == torch.int32


def test_all_knn_query_matches_reference(fitted):
    """The queries are the indexed rows, each its own first neighbour, and
    |q|^2 + |x|^2 - 2 q.x cancels in f32 (the self-distance is all
    cancellation): the two packages' products round apart by a few f32
    roundings of the norms. So the squared distances are compared with that
    absolute bound (8 eps * 2 max |x|^2) beside rtol 1e-5."""
    x, _, j, t = fitted
    jd, ji = jax_bc.all_knn_query(j, 5)
    td, ti = ball_cover.all_knn_query(t, 5)
    jd, td = np.asarray(jd, np.float64), td.double().numpy()
    atol = 8 * np.finfo(np.float32).eps * 2 * float((x.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(td ** 2, jd ** 2, rtol=1e-5, atol=atol)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), jd, atol=1e-4)


def _adjacency_equal_but_near_eps(a, b, dist, eps):
    a, b = np.asarray(a), np.asarray(b)
    near = np.abs(dist - eps) <= 1e-5 * eps
    assert np.all((a == b) | near)


def test_eps_nn_matches_reference(fitted):
    x, _, j, t = fitted
    q = x[:20]
    ja, jdeg = jax_bc.eps_nn(j, q, 1.5)
    ta, tdeg = ball_cover.eps_nn(t, q, 1.5)
    dist = np.sqrt(((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1))
    _adjacency_equal_but_near_eps(ta.numpy(), ja, dist, 1.5)
    assert tdeg.dtype == torch.int32
    np.testing.assert_array_equal(tdeg.numpy(), ta.numpy().sum(1))


def test_own_build_is_exact():
    """The reference test (test_extras.py::test_ball_cover_exact) on the port's build."""
    rng = np.random.default_rng(63)
    x = make_blobs(rng, 4000, 16)
    q = make_blobs(rng, 30, 16)
    idx = ball_cover.build(x, seed=0, device="cpu")
    d, i = ball_cover.knn_query(idx, q, 10)
    gtd, gti = naive_knn(q, x, 10, metric="euclidean")
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.999
    np.testing.assert_allclose(d.numpy(), gtd, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(d.numpy(), _exact_distances(q, x, i.numpy()), rtol=1e-4,
                               atol=1e-4)
    # radii bound every member's distance to its landmark
    inner = idx.inner
    lab = inner.lists.labels[:idx.size].long()
    rows = inner.sorted_data[:idx.size, :16]
    dl = torch.linalg.norm(rows - inner.centers[lab], dim=1)
    assert bool((dl <= idx.radii[lab] * (1 + 1e-6)).all())


def test_own_eps_nn_equals_eps_neighbors():
    rng = np.random.default_rng(64)
    x = make_blobs(rng, 1000, 4)
    idx = ball_cover.build(x, seed=0, device="cpu")
    adj, deg = ball_cover.eps_nn(idx, x[:20], 1.5)
    want, wdeg = epsilon_neighborhood.eps_neighbors(x[:20], x, 1.5, device="cpu")
    dist = np.sqrt(((x[:20, None, :].astype(np.float64) - x[None]) ** 2).sum(-1))
    _adjacency_equal_but_near_eps(adj.numpy(), want.numpy(), dist, 1.5)
    assert int(deg.sum()) > 20  # more than the self-matches


@pytest.mark.parametrize("metric,eps", [("euclidean", 2.0), ("sqeuclidean", 4.0), ("l1", 3.0)])
def test_eps_neighbors_matches_reference(metric, eps):
    rng = np.random.default_rng(65)
    x = make_blobs(rng, 300, 4)
    ja, jd = jax_eps.eps_neighbors(x[:50], x, eps, metric=metric)
    ta, td = epsilon_neighborhood.eps_neighbors(x[:50], x, eps, metric=metric, device="cpu")
    from cuvs_tpu_torch.distance.pairwise import pairwise_distance

    dist = pairwise_distance(x[:50], x, metric=metric, device="cpu").double().numpy()
    _adjacency_equal_but_near_eps(ta.numpy(), ja, dist, eps)
    assert td.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), ta.numpy().sum(1))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_cross_component_nn_matches_reference(metric):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((50, 4)).astype(np.float32)
    b = rng.standard_normal((60, 4)).astype(np.float32) + 10.0
    c = rng.standard_normal((40, 4)).astype(np.float32) - 10.0
    x = np.concatenate([a, b, c])
    comp = np.array([2] * 50 + [0] * 60 + [5] * 40)
    je = jax_cc.cross_component_nn(x, comp, metric=metric)
    te = cross_component.cross_component_nn(x, comp, metric=metric, device="cpu")
    assert te.dtype == np.float64 and te.shape == (3, 3)
    np.testing.assert_array_equal(te[:, :2], je[:, :2])
    np.testing.assert_allclose(te[:, 2], je[:, 2], rtol=1e-5)
    for src, dst, _ in te:
        assert comp[int(src)] != comp[int(dst)]


def test_cross_component_single_component():
    x = np.random.default_rng(9).standard_normal((20, 3)).astype(np.float32)
    te = cross_component.cross_component_nn(x, np.zeros(20, int), device="cpu")
    je = jax_cc.cross_component_nn(x, np.zeros(20, int))
    np.testing.assert_array_equal(te, je)
