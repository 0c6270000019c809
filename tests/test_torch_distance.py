"""Pairwise distances: the port against scipy and numpy (the counterparts of
tests/test_distance.py) and against the JAX package, on the CPU.

Tolerances: against the JAX package float32 rtol 1e-5 / atol 1e-5 for every
metric (the same formulas, summed in another order); the scipy and numpy
checks keep tests/test_distance.py's tolerances.
"""

import numpy as np
import pytest
import scipy.spatial.distance as spd
import torch

from cuvs_tpu.distance import pairwise as jax_pairwise
from cuvs_tpu_torch.distance.fused_l2_nn import fused_l2_argmin
from cuvs_tpu_torch.distance.pairwise import DistanceType, pairwise_distance

torch.set_num_threads(1)

RNG = np.random.default_rng(42)
X = RNG.random((37, 19)).astype(np.float32) + 0.01
Y = RNG.random((53, 19)).astype(np.float32) + 0.01
# probability rows for JSD/KL/Hellinger
XP = (X / X.sum(1, keepdims=True)).astype(np.float32)
YP = (Y / Y.sum(1, keepdims=True)).astype(np.float32)


def _pd(x, y, **kw):
    return pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), **kw).numpy()


SCIPY_CASES = [
    ("sqeuclidean", "sqeuclidean", X, Y, {}),
    ("euclidean", "euclidean", X, Y, {}),
    ("cosine", "cosine", X, Y, {}),
    ("l1", "cityblock", X, Y, {}),
    ("chebyshev", "chebyshev", X, Y, {}),
    ("canberra", "canberra", X, Y, {}),
    ("correlation", "correlation", X, Y, {}),
    ("braycurtis", "braycurtis", X, Y, {}),
    ("minkowski", "minkowski", X, Y, {"p": 3.0}),
    ("jensenshannon", "jensenshannon", XP, YP, {}),
]


@pytest.mark.parametrize("ours,scipy_name,x,y,kw", SCIPY_CASES)
def test_vs_scipy(ours, scipy_name, x, y, kw):
    np.testing.assert_allclose(_pd(x, y, metric=ours, **kw), spd.cdist(x, y, scipy_name, **kw),
                               rtol=2e-4, atol=2e-4)


def test_inner_product():
    np.testing.assert_allclose(_pd(X, Y, metric="inner_product"), X @ Y.T, rtol=1e-5)


def test_hellinger():
    want = np.sqrt(np.maximum(1.0 - np.sqrt(XP) @ np.sqrt(YP).T, 0.0))
    np.testing.assert_allclose(_pd(XP, YP, metric="hellinger"), want, rtol=1e-4, atol=1e-5)


def test_kl_divergence():
    want = np.array([[np.sum(a * np.log(a / b)) for b in YP] for a in XP])
    np.testing.assert_allclose(_pd(XP, YP, metric="kl_divergence"), want, rtol=1e-4, atol=1e-5)


def test_hamming():
    xb, yb = (X > 0.5).astype(np.float32), (Y > 0.5).astype(np.float32)
    np.testing.assert_allclose(_pd(xb, yb, metric="hamming"), spd.cdist(xb, yb, "hamming"),
                               rtol=1e-5, atol=1e-6)


def test_bitwise_hamming():
    xb = RNG.integers(0, 256, (10, 16)).astype(np.uint8)
    yb = RNG.integers(0, 256, (12, 16)).astype(np.uint8)
    want = np.array([[bin(int.from_bytes((a ^ b).tobytes(), "big")).count("1") for b in yb]
                     for a in xb], dtype=np.float32)
    np.testing.assert_allclose(_pd(xb, yb, metric="bitwise_hamming"), want)


def test_haversine():
    pts1 = ((RNG.random((5, 2)) - 0.5) * np.array([np.pi, 2 * np.pi])).astype(np.float32)
    pts2 = ((RNG.random((7, 2)) - 0.5) * np.array([np.pi, 2 * np.pi])).astype(np.float32)
    lat1, lon1 = pts1[:, None, 0], pts1[:, None, 1]
    lat2, lon2 = pts2[None, :, 0], pts2[None, :, 1]
    a = np.sin((lat2 - lat1) / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2
    np.testing.assert_allclose(_pd(pts1, pts2, metric="haversine"), 2 * np.arcsin(np.sqrt(a)),
                               rtol=1e-4, atol=1e-6)


def test_unexpanded_l2_matches_expanded():
    np.testing.assert_allclose(_pd(X, Y, metric=DistanceType.L2Unexpanded),
                               _pd(X, Y, metric=DistanceType.L2Expanded), rtol=1e-4, atol=1e-5)


def test_row_tiling_consistency():
    big = RNG.random((1000, 32)).astype(np.float32)
    other = RNG.random((53, 32)).astype(np.float32)
    np.testing.assert_allclose(_pd(big, other, metric="l1", row_tile=64),
                               _pd(big, other, metric="l1", row_tile=1024), rtol=1e-6)


def test_fused_l2_argmin():
    labels, dists = fused_l2_argmin(torch.from_numpy(X), torch.from_numpy(Y))
    full = spd.cdist(X, Y, "sqeuclidean")
    np.testing.assert_array_equal(labels.numpy(), full.argmin(1))
    np.testing.assert_allclose(dists.numpy(), full.min(1), rtol=1e-4, atol=1e-5)


def test_fused_l2_argmin_tiled():
    big = RNG.random((5000, 24)).astype(np.float32)
    cents = RNG.random((100, 24)).astype(np.float32)
    labels, _ = fused_l2_argmin(torch.from_numpy(big), torch.from_numpy(cents), row_tile=512)
    assert (labels.numpy() == spd.cdist(big, cents, "sqeuclidean").argmin(1)).mean() > 0.999


def _metric_inputs(metric, rng):
    """Inputs each metric is meant for: packed bits, (lat, lon) pairs,
    probability rows, 0/1 rows, or signed floats."""
    if metric == DistanceType.BitwiseHamming:
        return (rng.integers(0, 256, (40, 16)).astype(np.uint8),
                rng.integers(0, 256, (70, 16)).astype(np.uint8))
    if metric == DistanceType.Haversine:
        scale = np.array([np.pi, 2 * np.pi], np.float32)
        return ((rng.random((40, 2), np.float32) - 0.5) * scale,
                (rng.random((70, 2), np.float32) - 0.5) * scale)
    if metric in (DistanceType.JensenShannon, DistanceType.KLDivergence,
                  DistanceType.HellingerExpanded):
        x, y = rng.random((40, 24), np.float32) + 0.01, rng.random((70, 24), np.float32) + 0.01
        return x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    if metric in (DistanceType.HammingUnexpanded, DistanceType.JaccardExpanded,
                  DistanceType.DiceExpanded, DistanceType.RusselRaoExpanded):
        return ((rng.random((40, 24)) > 0.5).astype(np.float32),
                (rng.random((70, 24)) > 0.5).astype(np.float32))
    return rng.standard_normal((40, 24), np.float32), rng.standard_normal((70, 24), np.float32)


@pytest.mark.parametrize("metric", [m for m in DistanceType if m != DistanceType.Precomputed],
                         ids=lambda m: m.name)
def test_every_metric_matches_reference(metric):
    rng = np.random.default_rng(int(metric))
    x, y = _metric_inputs(metric, rng)
    want = np.asarray(jax_pairwise.pairwise_distance(x, y, metric=metric, p=3.0))
    got = _pd(x, y, metric=metric, p=3.0, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_compute_and_row_tile_match_reference():
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal((300, 20), np.float32), rng.standard_normal((90, 20), np.float32)
    import jax.numpy as jnp

    for metric in ("sqeuclidean", "cosine", "correlation", "jaccard"):
        want = np.asarray(jax_pairwise.pairwise_distance(x, y, metric=metric,
                                                         compute_dtype=jnp.bfloat16))
        got = _pd(x, y, metric=metric, compute_dtype=torch.bfloat16)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for metric in ("canberra", "braycurtis"):  # tiles of 8 rows, then one tile
        want = np.asarray(jax_pairwise.pairwise_distance(x, y, metric=metric, row_tile=8))
        np.testing.assert_allclose(_pd(x, y, metric=metric, row_tile=8), want,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_pd(x, y, metric=metric), want, rtol=1e-5, atol=1e-5)


def test_udf_precomputed_and_shapes():
    def l1(a, b):  # a metric UDF written once for both frameworks
        return abs(a[:, None, :] - b[None, :, :]).sum(-1)

    np.testing.assert_allclose(_pd(X, Y, metric=l1),
                               np.asarray(jax_pairwise.pairwise_distance(X, Y, metric=l1)),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="Precomputed"):
        _pd(X, Y, metric=DistanceType.Precomputed)
    with pytest.raises(ValueError, match="bad shapes"):
        _pd(X, Y[:, :5], metric="l1")
    with pytest.raises(ValueError, match="unknown metric"):
        _pd(X, Y, metric="spam")
