"""PCA, the quality statistics and the Gram / KDE kernels: the port against
the JAX package on the CPU.

PCA: explained variance rtol 1e-5; components up to a per-row sign (an
eigenvector's sign is the solver's choice); ``transform`` and
``inverse_transform`` of a fit carried across (``interop.pca_from_numpy``)
rtol 1e-5 (atol 1e-5 near 0). Silhouette and trustworthiness rtol 1e-5,
also on data with tied distances (the stable orderings decide the ranks).
Gram matrices (4 kernels) and KDE (6 kernels): rtol 1e-5 (atol 1e-6 near 0).
"""

import numpy as np
import pytest
import torch

from cuvs_tpu.distance import kernels as jax_kernels
from cuvs_tpu.preprocessing import pca as jax_pca
from cuvs_tpu.stats import scores as jax_scores
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.distance import kernels
from cuvs_tpu_torch.preprocessing import pca
from cuvs_tpu_torch.stats import silhouette_score, trustworthiness_score
from tests.utils import make_blobs

torch.set_num_threads(1)


def _low_rank(seed, n=600, d=24, rank=10):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, rank)) * np.linspace(5.0, 1.0, rank)
    return (z @ rng.standard_normal((rank, d)) + 0.05 * rng.standard_normal((n, d)) + 3.0
            ).astype(np.float32)


@pytest.mark.parametrize("n_components", [1, 8, 24])
def test_pca_fit_matches_reference(n_components):
    x = _low_rank(0)
    j = jax_pca.fit(x, n_components)
    t = pca.fit(x, n_components, device="cpu")
    np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), rtol=1e-5, atol=1e-5)
    ev = np.asarray(j.explained_variance)
    np.testing.assert_allclose(t.explained_variance.numpy(), ev, rtol=1e-5, atol=1e-5 * ev[0])
    # components up to a per-row sign, where the variance is separated
    jc, tc = np.asarray(j.components), t.components.numpy()
    signs = np.sign((jc * tc).sum(1))
    sep = np.ones(n_components, bool)
    gaps = np.abs(np.diff(ev)) > 1e-3 * ev[0]
    sep[:-1] &= gaps
    sep[1:] &= gaps
    np.testing.assert_allclose((tc * signs[:, None])[sep], jc[sep], atol=1e-4)


def test_pca_transform_and_inverse_on_a_carried_fit():
    x = _low_rank(1)
    j = jax_pca.fit(x, 8)
    t = interop.pca_from_numpy(j.mean, j.components, j.explained_variance, device="cpu")
    jz = np.asarray(jax_pca.transform(j, x))
    tz = pca.transform(t, x)
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pca.inverse_transform(t, tz).numpy(),
                               np.asarray(jax_pca.inverse_transform(j, jz)), rtol=1e-5, atol=1e-5)


def test_pca_round_trip_and_bounds():
    """The reference test (test_preprocessing.py::test_pca_roundtrip_and_variance) on the port."""
    x = _low_rank(2, d=16, rank=8)
    p = pca.fit(x, 8, device="cpu")
    back = pca.inverse_transform(p, pca.transform(p, x)).numpy()
    assert np.abs(back - x).max() < 0.5
    assert (np.diff(p.explained_variance.numpy()) <= 1e-6).all()
    full = pca.fit(x, 16, device="cpu")
    np.testing.assert_allclose(pca.inverse_transform(full, pca.transform(full, x)).numpy(), x,
                               rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError):
        pca.fit(x, 17, device="cpu")


def _labels(seed, n, k):
    return np.random.default_rng(seed).integers(0, k, n)


@pytest.mark.parametrize("case", ["blobs", "ties", "chunked", "singleton"])
def test_silhouette_matches_reference(case):
    rng = np.random.default_rng(10)
    if case == "ties":  # integer grid: many equal distances
        x = rng.integers(0, 3, (300, 4)).astype(np.float32)
        labels = _labels(1, 300, 3)
    else:
        x = make_blobs(rng, 500, 8, n_centers=4, scale=0.5)
        labels = _labels(2, 500, 4)
    kw = {}
    if case == "chunked":
        kw = dict(chunk=64)
    if case == "singleton":
        labels = labels.copy()
        labels[7] = 4  # a cluster of one row scores 0
    want = float(jax_scores.silhouette_score(x, labels, **kw))
    got = silhouette_score(x, labels, device="cpu", **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("case", ["noise", "identity", "ties", "projection"])
def test_trustworthiness_matches_reference(case):
    rng = np.random.default_rng(20)
    x = make_blobs(rng, 300, 16)
    if case == "noise":
        e = rng.standard_normal((300, 2)).astype(np.float32)
    elif case == "identity":
        e = x.copy()
    elif case == "ties":  # a coarse grid: ties in both orderings
        x = rng.integers(0, 3, (300, 5)).astype(np.float32)
        e = x[:, :2].copy()
    else:
        e = x[:, :3].copy()
    want = float(jax_scores.trustworthiness_score(x, e, 5))
    got = trustworthiness_score(x, e, 5, device="cpu")
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    if case == "identity":
        assert float(got) > 0.999


@pytest.mark.parametrize("kernel,kw", [
    (kernels.KernelType.LINEAR, {}),
    (kernels.KernelType.POLYNOMIAL, dict(gamma=2.0, coef0=1.0, degree=2)),
    (kernels.KernelType.RBF, dict(gamma=0.5)),
    (kernels.KernelType.TANH, dict(gamma=0.1, coef0=0.2)),
])
@pytest.mark.parametrize("with_y", [True, False])
def test_gram_matrix_matches_reference(kernel, kw, with_y):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    y = rng.standard_normal((25, 6)).astype(np.float32) if with_y else None
    want = np.asarray(jax_kernels.gram_matrix(x, y, jax_kernels.KernelType(int(kernel)), **kw))
    got = kernels.gram_matrix(x, y, kernel, device="cpu", **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel", list(kernels.DensityKernelType))
@pytest.mark.parametrize("bandwidth,metric", [(1.0, "euclidean"), (0.7, "l1")])
def test_kde_matches_reference(kernel, bandwidth, metric):
    rng = np.random.default_rng(6)
    samples = rng.standard_normal((500, 2)).astype(np.float32)
    x = rng.standard_normal((30, 2)).astype(np.float32)
    want = np.asarray(jax_kernels.kde(x, samples, bandwidth=bandwidth,
                                      kernel=jax_kernels.DensityKernelType(int(kernel)),
                                      metric=metric))
    got = kernels.kde(x, samples, bandwidth=bandwidth, kernel=kernel, metric=metric, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_kde_orders_dense_and_sparse_points():
    """The reference test (test_extras.py::test_kde) on the port."""
    samples = np.random.default_rng(6).standard_normal((2000, 2)).astype(np.float32)
    for kern in kernels.DensityKernelType:
        hi = float(kernels.kde(np.zeros((1, 2), np.float32), samples, kernel=kern, device="cpu")[0])
        lo = float(kernels.kde(np.full((1, 2), 4.0, np.float32), samples, kernel=kern,
                               device="cpu")[0])
        assert hi > lo, kern

