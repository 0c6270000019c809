"""Balanced hierarchical k-means — port of ``cuvs_tpu.cluster.kmeans_balanced``.

The IVF coarse-quantizer trainer (kmeans_balanced.cuh): train on a subsample,
mesocluster EM over ~sqrt(k) groups, fine clusters per mesocluster in
proportion to its size, then EM with soft balancing (squared distances to
oversized clusters weighted by sqrt(count/avg)) and teleporting of undersized
centers. Randomness comes from one ``torch.Generator`` seeded from
``seed``; it draws other numbers than the reference's ``jax.random`` from the
same seed, so the two packages build different (equally balanced) centers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.distance.fused_l2_nn import fused_l2_argmin
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


@dataclasses.dataclass(frozen=True)
class BalancedParams:
    """Mirrors cuvs::cluster::kmeans::balanced_params (kmeans.hpp:159)."""

    n_clusters: int = 1024
    n_iters: int = 20
    balancing_em_iters: int = 5
    trainset_fraction: float = 1.0
    seed: int = 0
    compute_dtype: object = torch.float32


def _segment_mean(x, labels, k, centers):
    """Per-cluster means; empty clusters keep their old center.

    Each cluster's rows are summed in row order by a segmented reduction over
    the rows sorted by label: the same sums on every run, where an atomic
    ``index_add_`` on CUDA adds in a varying order and makes the build
    irreproducible."""
    labels = labels.long()
    counts = torch.bincount(labels, minlength=k)
    sums = torch.segment_reduce(x[torch.argsort(labels, stable=True)], "sum", lengths=counts)
    counts = counts.float()
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centers), counts


def _em_iters(x, centers, n_iters, compute_dtype):
    for _ in range(n_iters):
        labels, _ = fused_l2_argmin(x, centers, compute_dtype=compute_dtype)
        centers, _ = _segment_mean(x, labels, centers.shape[0], centers)
    return centers


def _balancing_iters(gen, x, centers, n_iters, compute_dtype):
    """EM with soft balancing + adaptive center adjustment
    (kmeans_balanced.cuh:645-810). The final iteration uses the unweighted
    metric, so predict() assigns points honestly."""
    n = x.shape[0]
    k = centers.shape[0]
    avg = n / k
    for it in range(n_iters):
        last = it == n_iters - 1
        labels0, _ = fused_l2_argmin(x, centers, compute_dtype=compute_dtype)
        counts0 = torch.bincount(labels0.long(), minlength=k).float()
        # only oversized clusters are penalized (clamped at 1)
        penalty = torch.sqrt(torch.clamp_min(counts0 / avg, 1.0))
        if last:
            penalty = torch.ones_like(penalty)
        labels, _ = fused_l2_argmin(x, centers, compute_dtype=compute_dtype,
                                    center_weights=penalty)
        new, counts = _segment_mean(x, labels, k, centers)
        # teleport small clusters onto members of big clusters, sampled in
        # proportion to their cluster's size
        point_weight = torch.clamp_min(counts[labels.long()], 1e-9)
        donor_idx = torch.multinomial(point_weight, k, replacement=True, generator=gen)
        if not last:
            small = counts < avg * 0.25
            new = torch.where(small[:, None], x[donor_idx], new)
        centers = new
    return centers


def _fit_impl(gen, x, n_clusters, n_meso, n_iters, bal_iters, compute_dtype):
    n = x.shape[0]
    dev = x.device
    # 1) mesocluster EM over ~sqrt(k) groups
    meso_idx = torch.randperm(n, generator=gen, device=dev)[:n_meso]
    meso_centers = _em_iters(x, x[meso_idx], max(2, n_iters // 2), compute_dtype)
    meso_labels, _ = fused_l2_argmin(x, meso_centers, compute_dtype=compute_dtype)

    # 2) fine clusters per mesocluster in proportion to its size; remainder
    #    to the largest fractional parts; init by evenly strided picks from
    #    the rows sorted by mesocluster
    counts = torch.bincount(meso_labels.long(), minlength=n_meso).float()
    alloc_f = counts / n * n_clusters
    alloc = torch.clamp_min(torch.floor(alloc_f), 1.0).to(torch.int64)
    deficit = n_clusters - int(alloc.sum())
    order = torch.argsort(-(alloc_f - torch.floor(alloc_f)), stable=True)
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(n_meso, device=dev)
    bump = torch.where(rank_of < abs(deficit), 1 if deficit >= 0 else -1, 0)
    alloc = torch.clamp_min(alloc + bump, 1)
    meso_offsets = torch.cumsum(alloc, 0) - alloc

    sorted_x = x[torch.argsort(meso_labels, stable=True)]
    cnt_i = counts.to(torch.int64)
    point_offsets = torch.cumsum(cnt_i, 0) - cnt_i
    fine_ids = torch.arange(n_clusters, device=dev)
    meso_of_fine = torch.searchsorted(torch.cumsum(alloc, 0), fine_ids, right=True)
    meso_of_fine = torch.clamp_max(meso_of_fine, n_meso - 1)
    t = fine_ids - meso_offsets[meso_of_fine]
    block = cnt_i[meso_of_fine]
    frac = ((t.float() + 0.5) / alloc[meso_of_fine].float() * block.float()).to(torch.int64)
    pick = point_offsets[meso_of_fine] + torch.minimum(frac, torch.clamp_min(block - 1, 0))
    fine_centers = sorted_x[torch.clamp_max(pick, n - 1)]

    # 3) fine EM + balancing
    fine_centers = _em_iters(x, fine_centers, n_iters, compute_dtype)
    return _balancing_iters(gen, x, fine_centers, bal_iters, compute_dtype)


def fit(x, n_clusters: int, params: Optional[BalancedParams] = None, device=None,
        **kw) -> torch.Tensor:
    """Train a balanced coarse quantizer. Returns centers [n_clusters, d] f32
    on x's device (host data: ``device``, None for the CUDA card)."""
    if params is None:
        params = BalancedParams(n_clusters=n_clusters, **kw)
    x = _on_device(x, device).float()
    n = x.shape[0]
    gen = torch.Generator(device=x.device)
    gen.manual_seed(params.seed)
    if params.trainset_fraction < 1.0:
        m = min(n, max(n_clusters * 4, int(n * params.trainset_fraction)))
        x = x[torch.randperm(n, generator=gen, device=x.device)[:m]]
    n_meso = max(1, int(math.ceil(math.sqrt(n_clusters))))
    if n_clusters >= x.shape[0]:
        # degenerate: more clusters than points — repeat the points
        reps = -(-n_clusters // x.shape[0])
        return x.repeat(reps, 1)[:n_clusters]
    return _fit_impl(gen, x, int(n_clusters), n_meso, int(params.n_iters),
                     int(params.balancing_em_iters), params.compute_dtype)


def predict(x, centers, compute_dtype=torch.float32, device=None) -> torch.Tensor:
    """Nearest-center label per row [n] int32 (host data: ``device``, None
    for the CUDA card; centers follow x)."""
    x = _on_device(x, device).float()
    return fused_l2_argmin(x, _on_device(centers, x.device).float(),
                           compute_dtype=compute_dtype)[0]


def fit_predict(x, n_clusters: int, params: Optional[BalancedParams] = None, device=None,
                **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fit`` then ``predict`` on the same rows: (labels [n] int32, centers)."""
    x = _on_device(x, device)
    centers = fit(x, n_clusters, params, **kw)
    return predict(x, centers), centers
