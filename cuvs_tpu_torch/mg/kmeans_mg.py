"""Multi-device k-means: per-shard partial sums added on the root device —
port of ``cuvs_tpu.mg.kmeans_mg``.

MG k-means (kmeans_mg.cuh: per-rank partial sums and an allreduce of the
weights, centroids and cost at :262,310,394,474,622,629,718). The rows are
cut into contiguous blocks of ceil(n / S) rows, the last one shorter, each on
its device. Every Lloyd iteration assigns each block where it lives, sums its
rows per cluster in row order, and adds the blocks' sums, counts and costs on
the root device in block order: that sum stands in for the reference's
``psum``. The centres then go back to every device. The same math as
``cluster.kmeans``'s loop, so the centres agree up to the order of the sums.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.cluster import kmeans
from cuvs_tpu_torch.distance.fused_l2_nn import fused_l2_argmin
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


def _blocks(x, devices):
    """Contiguous row blocks of ceil(n / S) rows, block s on devices[s] (a
    block already there is a view)."""
    n = x.shape[0]
    block = -(-n // len(devices))
    out = []
    for s, dev in enumerate(devices):
        rows = x[s * block:min(n, (s + 1) * block)]
        if rows.shape[0]:
            out.append(rows.to(dev).float())
    return out


def fit(x, n_clusters: int, devices: Optional[Sequence] = None, max_iter: int = 50,
        tol: float = 1e-4, seed: int = 0, compute_dtype=torch.float32, init_centers=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed Lloyd k-means over ``devices`` (None: every CUDA device).
    Returns (centers [k, d], inertia) on the root device, devices[0].

    The seeding is the reference's: k-means++ on a subsample of min(n,
    max(32 k, 4096)) rows, drawn on the root device. ``init_centers`` (not in
    the reference) starts the loop from given centres instead, so a test can
    hold it against ``cluster.kmeans.fit(init_centers=...)``. The inertia is
    the cost of the last iteration's assignment, as in the reference."""
    from cuvs_tpu_torch.mg.snmg import default_devices

    devices = [torch.device(d) for d in (devices or default_devices())]
    root = devices[0]
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))  # host rows stay
    n = x.shape[0]
    blocks = _blocks(x, devices)
    if init_centers is not None:
        centers = _on_device(init_centers, root).float()
    else:
        gen = kmeans._generator(seed, root)
        m = min(n, max(n_clusters * 32, 4096))
        pick = torch.randperm(n, generator=gen, device=root)[:m]
        sub = x[pick.to(x.device)].to(root).float()
        centers = kmeans._kmeans_pp_init(gen, sub, n_clusters)
    prev, inertia, it = float("inf"), float("inf"), 0
    cost = torch.tensor(float("inf"), device=root)
    while it < max_iter:
        if it >= 2 and not abs(prev - inertia) / max(prev, 1e-30) > tol:
            break
        sums = counts = None
        cost = torch.zeros((), device=root)
        for xb in blocks:
            c = centers.to(xb.device)
            labels, mind = fused_l2_argmin(xb, c, compute_dtype=compute_dtype)
            w = torch.ones((xb.shape[0],), device=xb.device)
            s_b, n_b = kmeans._segment_sums(xb, labels, w, n_clusters)
            s_b, n_b = s_b.to(root), n_b.to(root)
            sums = s_b if sums is None else sums + s_b
            counts = n_b if counts is None else counts + n_b
            cost = cost + mind.sum().to(root)
        centers = kmeans._new_centers(sums, counts, centers)
        prev, inertia, it = inertia, float(cost), it + 1
    return centers, cost
