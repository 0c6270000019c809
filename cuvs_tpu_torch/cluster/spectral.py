"""Spectral clustering: Laplacian eigenmap embedding + k-means — port of
``cuvs_tpu.cluster.spectral`` (cpp/src/cluster/detail/spectral.cuh:38-55)."""

from __future__ import annotations

from typing import Tuple

import torch

from cuvs_tpu_torch.cluster import kmeans
from cuvs_tpu_torch.preprocessing.spectral import spectral_embedding


def fit_predict(x, n_clusters: int, n_components: int = None, n_neighbors: int = 15,
                seed: int = 0, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (labels [n], embedding [n, n_components]). Host data goes to
    ``device`` (None: the CUDA card)."""
    if n_components is None:
        n_components = n_clusters
    emb = spectral_embedding(x, n_components=n_components, n_neighbors=n_neighbors, seed=seed,
                             device=device)
    _, labels, _, _ = kmeans.fit(emb, n_clusters=n_clusters, seed=seed)
    return labels, emb
