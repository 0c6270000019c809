"""k-means clustering (Lloyd) with k-means++ seeding — port of ``cuvs_tpu.cluster.kmeans``.

``cuvs::cluster::kmeans::{fit,predict,fit_predict,transform,cluster_cost}``
(kmeans.hpp:37-125): n_clusters=8, max_iter=300, tol=1e-4, init k-means++,
random or an array. Assignment is the fused distance + argmin
(``distance.fused_l2_argmin``); the weighted centre update sums each
cluster's rows in row order (a segmented reduction over the rows sorted by
label), so a fit gives the same centres on every run, where an atomic
``index_add_`` on CUDA would add in a varying order. The Lloyd loop is a
plain loop with the reference's stop rule: at least 2 iterations, then on
while the inertia moved by more than ``tol`` relative to the previous one.

k-means++ draws from a ``torch.Generator`` seeded by ``params.seed``; its
draws differ from the reference's ``jax.random`` ones. The draws are split
from the work (``_kmeans_pp_init(..., picks=...)``), so a test can feed fixed
picks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.distance.fused_l2_nn import fused_l2_argmin
from cuvs_tpu_torch.distance.pairwise import DistanceType, pairwise_distance
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


@dataclasses.dataclass(frozen=True)
class KMeansParams:
    """Mirrors cuvs::cluster::kmeans::params defaults (kmeans.hpp:37-125)."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: str = "kmeans++"  # "kmeans++" | "random" | "array"
    seed: int = 0
    metric: DistanceType = DistanceType.L2Expanded
    batch_samples: int = 1 << 15


def _assign(x, centers, compute_dtype=torch.float32):
    return fused_l2_argmin(x, centers, compute_dtype=compute_dtype)


def _segment_sums(x, labels, weights, n_clusters):
    """Per-cluster weighted row sums [k, d] and weights [k], each cluster's
    rows summed in row order; an empty cluster sums to 0."""
    labels = labels.long()
    order = torch.argsort(labels, stable=True)
    lengths = torch.bincount(labels, minlength=n_clusters)
    w = weights[order]
    sums = torch.segment_reduce(x[order] * w[:, None], "sum", lengths=lengths)
    counts = torch.segment_reduce(w, "sum", lengths=lengths)
    return sums, counts


def _new_centers(sums, counts, old_centers):
    """Weighted means; an empty cluster keeps its previous centre."""
    new = sums / torch.clamp_min(counts, 1e-12)[:, None]
    return torch.where(counts[:, None] > 0, new, old_centers)


def _kmeans_pp_init(gen, x, n_clusters: int, picks=None) -> torch.Tensor:
    """k-means++ seeding: each next centre drawn with probability
    proportional to its row's squared distance to the nearest centre so far
    (the reference's logits log(max(d, 1e-30))).

    Each step is a handful of launches on x's device and no host sync: the
    draw (``torch.multinomial``), one matrix-vector product and a minimum.
    ``picks`` [n_clusters] fixes the rows instead of drawing them."""
    n = x.shape[0]
    if picks is not None:
        return x[torch.as_tensor(picks, device=x.device).long()]
    xf = x.float()
    xn = (xf * xf).sum(1)
    idx = torch.empty((n_clusters,), dtype=torch.long, device=x.device)
    idx[:1] = torch.randint(0, n, (1,), generator=gen, device=x.device)

    def sq_dist(i):
        c = xf[i]  # [1, d]
        return torch.clamp_min(xn - 2.0 * (xf @ c[0]) + (c * c).sum(), 0.0)

    min_d = sq_dist(idx[:1])
    for j in range(1, n_clusters):
        idx[j:j + 1] = torch.multinomial(torch.clamp_min(min_d, 1e-30), 1, generator=gen)
        min_d = torch.minimum(min_d, sq_dist(idx[j:j + 1]))
    return x[idx]


def _initial_centers(gen, x, params: KMeansParams, init: str, init_centers):
    if init == "array":
        return _on_device(init_centers, x.device).float()
    if init == "random":
        return x[torch.randperm(x.shape[0], generator=gen, device=x.device)[:params.n_clusters]]
    return _kmeans_pp_init(gen, x, params.n_clusters)


def _lloyd(x, weights, centers, max_iter: int, tol: float):
    """The reference's loop: stop after max_iter, or from the third
    iteration on once the inertia moved by at most tol (relative)."""
    prev, inertia, it = float("inf"), float("inf"), 0
    while it < max_iter:
        if it >= 2 and not abs(prev - inertia) / max(prev, 1e-30) > tol:
            break
        labels, dists = _assign(x, centers)
        sums, counts = _segment_sums(x, labels, weights, centers.shape[0])
        centers = _new_centers(sums, counts, centers)
        prev, inertia, it = inertia, float((dists * weights).sum()), it + 1
    return centers, it


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def fit(x, params: Optional[KMeansParams] = None, n_clusters: Optional[int] = None,
        sample_weights=None, init_centers=None, device=None, **kw
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Lloyd k-means. Returns (centers [k, d], labels [n] int32, inertia (0-d
    f32), n_iter) on x's device (host data: ``device``, None for the card)."""
    if params is None:
        params = KMeansParams(n_clusters=n_clusters or 8, **kw)
    x = _on_device(x, device).float()
    n = x.shape[0]
    w = (torch.ones((n,), device=x.device) if sample_weights is None
         else _on_device(sample_weights, x.device).float())
    init = params.init if init_centers is None else "array"
    gen = _generator(params.seed, x.device)
    centers0 = _initial_centers(gen, x, params, init, init_centers)
    centers, n_iter = _lloyd(x, w, centers0, params.max_iter, params.tol)
    labels, dists = _assign(x, centers)
    return centers, labels, (dists * w).sum(), n_iter


def predict(x, centers, device=None) -> torch.Tensor:
    """Nearest-centre labels [n] int32 (centres follow x)."""
    x = _on_device(x, device).float()
    return _assign(x, _on_device(centers, x.device).float())[0]


def fit_predict(x, params: Optional[KMeansParams] = None, **kw):
    centers, labels, _, _ = fit(x, params, **kw)
    return labels, centers


def transform(x, centers, device=None) -> torch.Tensor:
    """Distances from each sample to each cluster centre [n, k]."""
    x = _on_device(x, device)
    return pairwise_distance(x, _on_device(centers, x.device), metric=DistanceType.L2SqrtExpanded)


def cluster_cost(x, centers, device=None) -> torch.Tensor:
    """Sum of squared distances to the closest centre (inertia)."""
    x = _on_device(x, device).float()
    return _assign(x, _on_device(centers, x.device).float())[1].sum()


def find_k(x, kmax: int, kmin: int = 1, max_iter: int = 100, tol: float = 1e-3, seed: int = 0,
           device=None) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Binary-search k by the inertia elbow (kmeans_auto_find_k.cuh).
    Returns (best_k, centers, inertia)."""
    x = _on_device(x, device)

    def cost(k):
        centers, _, inertia, _ = fit(x, KMeansParams(n_clusters=int(k), max_iter=max_iter,
                                                     seed=seed))
        return float(inertia), centers

    lo, hi = kmin, kmax
    c_hi, cent_hi = cost(hi)
    best = (hi, cent_hi, c_hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        c_mid, cent_mid = cost(mid)
        # relative improvement from mid to hi; if small, mid is enough
        if (c_mid - c_hi) / max(c_mid, 1e-30) < tol:
            hi, c_hi = mid, c_mid
            best = (mid, cent_mid, c_mid)
        else:
            lo = mid
    return best[0], best[1], torch.tensor(best[2], dtype=torch.float32, device=x.device)
