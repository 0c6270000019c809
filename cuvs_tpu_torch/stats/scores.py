"""Clustering and embedding quality statistics — port of ``cuvs_tpu.stats.scores``.

cuvs::stats silhouette_score (with its batched variant) and
trustworthiness_score (silhouette_score.hpp, trustworthiness_score.hpp).
"""

from __future__ import annotations

import torch

from cuvs_tpu_torch.distance.pairwise import pairwise_distance
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


def silhouette_score(x, labels, n_clusters: int = None, metric="euclidean", chunk: int = 2048,
                     device=None) -> torch.Tensor:
    """Mean silhouette coefficient over all samples (0-d f32 tensor).

    s(i) = (b_i - a_i) / max(a_i, b_i), a = mean intra-cluster distance,
    b = min over other clusters of the mean distance to that cluster.
    Computed in row chunks of ``chunk`` (the reference's batched variant),
    each chunk's per-cluster sums one product with the one-hot labels.
    Host data goes to ``device`` (None: the CUDA card); labels follow x.
    """
    x = _on_device(x, device).float()
    labels = _on_device(labels, x.device).long()
    n = x.shape[0]
    if n_clusters is None:
        n_clusters = int(labels.max()) + 1
    onehot = torch.nn.functional.one_hot(labels, n_clusters).float()  # [n, k]
    counts = onehot.sum(0)
    sil_sum = torch.zeros((), device=x.device)
    for s in range(0, n, chunk):
        lc = labels[s:s + chunk]
        d = pairwise_distance(x[s:s + chunk], x, metric=metric)  # [c, n]
        per_cluster_sum = d @ onehot  # [c, k]
        own = counts[lc]
        a = per_cluster_sum.gather(1, lc[:, None])[:, 0] / torch.clamp_min(own - 1.0, 1.0)
        mean_to = per_cluster_sum / torch.clamp_min(counts[None, :], 1.0)
        mean_to[torch.arange(lc.shape[0], device=x.device), lc] = float("inf")
        b = mean_to.min(1).values
        s_i = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-30)
        s_i = torch.where(own > 1, s_i, 0.0)  # singleton clusters score 0
        sil_sum = sil_sum + s_i.sum()
    return sil_sum / n


def trustworthiness_score(x, x_embedded, n_neighbors: int = 5, metric="sqeuclidean",
                          device=None) -> torch.Tensor:
    """How much an embedding preserves local structure (0-d f32 tensor in [0, 1]).

    T = 1 - 2/(n*k*(2n - 3k - 1)) * sum_i sum_{j in kNN_emb(i) \\ kNN_orig(i)}
        (rank_orig(i, j) - k)

    Both orderings are stable sorts (``jnp.argsort``'s): tied distances keep
    the lower index first, and the ranks, so the score, depend on it. The
    penalty is an integer sum, taken exactly. Host data goes to ``device``
    (None: the CUDA card); the embedding follows x.
    """
    x = _on_device(x, device).float()
    e = _on_device(x_embedded, x.device).float()
    n = x.shape[0]
    k = n_neighbors
    diag = torch.arange(n, device=x.device)
    d_orig = pairwise_distance(x, x, metric=metric)
    d_orig[diag, diag] = float("inf")
    # rank of j in i's original ordering (0-based over non-self)
    order_orig = torch.argsort(d_orig, dim=1, stable=True)
    del d_orig
    ranks = torch.empty((n, n), dtype=torch.int64, device=x.device)
    ranks.scatter_(1, order_orig, diag[None, :].expand(n, n))
    del order_orig
    d_emb = pairwise_distance(e, e, metric=metric)
    d_emb[diag, diag] = float("inf")
    emb_knn = torch.argsort(d_emb, dim=1, stable=True)[:, :k]
    r = ranks.gather(1, emb_knn)  # [n, k]
    penalty = torch.clamp_min(r - k + 1, 0).sum().float()
    denom = n * k * (2.0 * n - 3.0 * k - 1.0)
    return 1.0 - (2.0 / denom) * penalty
