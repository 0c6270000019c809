"""PCA: fit / transform / inverse_transform — port of ``cuvs_tpu.preprocessing.pca``.

cuvs::preprocessing::pca (pca.hpp:23-178, params{n_components}): the
covariance is one product over the rows, in IEEE fp32, and its
eigendecomposition one ``torch.linalg.eigh`` of the [d, d] matrix.
"""

from __future__ import annotations

import dataclasses

import torch

from cuvs_tpu_torch.utils.device import as_tensor as _on_device


@dataclasses.dataclass
class PCA:
    mean: torch.Tensor  # [d]
    components: torch.Tensor  # [n_components, d] (rows = principal axes)
    explained_variance: torch.Tensor  # [n_components]


def fit(dataset, n_components: int, device=None) -> PCA:
    """The first ``n_components`` principal axes of the rows, largest variance
    first. Host data goes to ``device`` (None: the CUDA card)."""
    x = _on_device(dataset, device).float()
    n, d = x.shape
    if not (1 <= n_components <= d):
        raise ValueError(f"n_components must be in [1, {d}]")
    mean = x.mean(0)
    xc = x - mean[None, :]
    cov = (xc.T @ xc) / max(n - 1, 1)
    del xc
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    order = torch.argsort(-evals, stable=True)[:n_components]
    return PCA(mean=mean, components=evecs[:, order].T.contiguous(),
               explained_variance=evals[order])


def transform(p: PCA, dataset) -> torch.Tensor:
    """Rows projected on the principal axes [n, n_components] (rows follow
    the PCA's device)."""
    x = _on_device(dataset, p.mean.device).float()
    return (x - p.mean[None, :]) @ p.components.T


def inverse_transform(p: PCA, projected) -> torch.Tensor:
    """Projections back in the input space [n, d]."""
    z = _on_device(projected, p.mean.device).float()
    return z @ p.components + p.mean[None, :]
