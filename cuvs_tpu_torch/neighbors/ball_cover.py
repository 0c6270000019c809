"""Random Ball Cover: exact k-NN / eps-NN with landmark pruning — port of
``cuvs_tpu.neighbors.ball_cover``.

``cuvs::neighbors::ball_cover`` (ball_cover.hpp:173-334; landmark sampling
and triangle-inequality pruning, ball_cover.cuh:66-91). The landmarks are an
IVF-Flat index's balanced k-means centres, and the rows sit in its dense
sorted-by-cell layout. Results are exact: a query skips a cell only when the
triangle-inequality lower bound ``d(q, L_c) - radius_c`` exceeds its current
certificate (the k-th best distance after probing its closest cells first).
For eps-NN the bound is eps.

The reference's scan over every cell (a ``lax.scan``) is a loop over the
cells here; a cell that no query needs is skipped, which changes nothing
(every entry it would merge is +inf, and the stable merge keeps what it
has). Each step is one [nq, W] product over the cell's 128-aligned window
(``ivf_flat.Index.window``), a stable top-k and a stable merge.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.neighbors import ivf_flat
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


@dataclasses.dataclass
class Index:
    inner: ivf_flat.Index  # the sorted-cell layout
    radii: torch.Tensor  # [n_cells] max distance of a member to its landmark

    @property
    def size(self) -> int:
        return self.inner.size

    @property
    def device(self) -> torch.device:
        return self.inner.device


def build(dataset, n_landmarks: Optional[int] = None, metric="euclidean", seed: int = 0,
          device=None) -> Index:
    """Landmarks ~ sqrt(n) by default (ball_cover.cuh:66-91). Host data goes
    to ``device`` (None: the CUDA card)."""
    dataset = _on_device(dataset, device)
    n = dataset.shape[0]
    normalize_metric(metric)  # validated; the cells are always L2
    if n_landmarks is None:
        n_landmarks = max(1, int(n ** 0.5))
    inner = ivf_flat.build(dataset, n_lists=n_landmarks, metric=DistanceType.L2Expanded, seed=seed)
    # per-cell radius: the largest member distance to its landmark
    xf = dataset.float()
    labels = kmeans_balanced.predict(xf, inner.centers).long()
    d2 = ((xf - inner.centers[labels]) ** 2).sum(1)
    radii = torch.zeros((inner.n_lists,), device=xf.device).scatter_reduce_(
        0, labels, torch.sqrt(d2), "amax", include_self=True)
    return Index(inner=inner, radii=radii)


def _landmark_distances(inner: ivf_flat.Index, qf: torch.Tensor) -> torch.Tensor:
    """sqrt-L2 distances of the queries to every landmark [nq, n_cells]."""
    return torch.sqrt(torch.clamp_min(
        (qf * qf).sum(1)[:, None] + inner.center_norms[None, :]
        - 2.0 * pairwise._gemm(qf, inner.centers, torch.float32), 0.0))


def knn_query(index: Index, queries, k: int, two_pass: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN (ball_cover.hpp:215 ``knn_query``). Returns (sqrt-L2
    distances [nq, k], ids [nq, k] int32); host queries go to the index's
    device.

    Pass 1 probes the closest ~sqrt(cells) cells for a distance certificate;
    pass 2 scans only the cells whose triangle-inequality lower bound beats
    it and that pass 1 did not scan.
    """
    inner = index.inner
    qf = _on_device(queries, inner.device).float()
    n_cells = inner.n_lists
    nq = qf.shape[0]
    dc = _landmark_distances(inner, qf)

    p1 = max(1, min(n_cells, int(n_cells ** 0.5) + 1))
    close_cells = topk(dc, p1, True)[1]
    needed1 = torch.zeros((nq, n_cells), dtype=torch.bool, device=qf.device)
    needed1.scatter_(1, close_cells, True)
    d1, i1 = _masked_full_scan(inner, qf, k, needed1)
    if not two_pass or p1 == n_cells:
        return ivf.postprocess_distances(d1, DistanceType.L2SqrtExpanded), i1
    cert = torch.sqrt(torch.clamp_min(d1[:, -1], 0.0))  # k-th best, sqrt space

    lower = dc - index.radii[None, :]
    needed2 = (lower <= cert[:, None]) & ~needed1
    d2, i2 = _masked_full_scan(inner, qf, k, needed2)
    tv, tl = topk(torch.cat([d1, d2], 1), k, True)
    out_i = torch.cat([i1, i2], 1).gather(1, tl)
    return ivf.postprocess_distances(tv, DistanceType.L2SqrtExpanded), out_i


def all_knn_query(index: Index, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN of every indexed point (ball_cover.hpp:173), in the index's
    sorted row order, as the reference returns them."""
    return knn_query(index, index.inner.sorted_data[:index.size, :index.inner.dim], k)


def _masked_full_scan(inner: ivf_flat.Index, qf: torch.Tensor, k: int, needed: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (squared L2, ids) over the cells, each row of cell c counted for
    the queries with ``needed[:, c]``."""
    nq, dim = qf.shape
    qnorm = (qf * qf).sum(1)
    W = inner.window
    kk = min(k, W)
    best_v = torch.full((nq, k), float("inf"), device=qf.device)
    best_i = torch.zeros((nq, k), dtype=torch.int32, device=qf.device)
    offsets = inner.lists.offsets.tolist()
    for c in torch.nonzero(needed.any(0)).flatten().tolist():
        start = offsets[c]
        data_w = inner.sorted_data[start:start + W, :dim]
        ids_w = inner.lists.ids[start:start + W]
        lab_w = inner.lists.labels[start:start + W]
        norm_w = inner.sorted_norms[start:start + W]
        dots = pairwise._gemm(qf, data_w, torch.float32)
        dist = torch.clamp_min(qnorm[:, None] + norm_w[None, :] - 2.0 * dots, 0.0)
        valid = (lab_w == c)[None, :] & needed[:, c][:, None]
        dist = torch.where(valid, dist, float("inf"))
        tv, tl = topk(dist, kk, True)
        sv, sidx = topk(torch.cat([best_v, tv], 1), k, True)
        best_v, best_i = sv, torch.cat([best_i, ids_w[tl]], 1).gather(1, sidx)
    return best_v, best_i


def eps_nn(index: Index, queries, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-radius neighbours as a dense boolean adjacency [nq, n] and the
    degrees [nq] int32 (ball_cover.hpp:300 ``eps_nn``). Cells whose lower
    bound exceeds eps are pruned. A host loop over the cells (~sqrt n), one
    read of the offsets and sizes; each cell's own rows are scattered, which
    is the reference's window with its label mask."""
    inner = index.inner
    qf = _on_device(queries, inner.device).float()
    dim = qf.shape[1]
    needed = (_landmark_distances(inner, qf) - index.radii[None, :]) <= eps
    adj = torch.zeros((qf.shape[0], index.size), dtype=torch.bool, device=qf.device)
    qnorm = (qf * qf).sum(1)
    for c, (start, size) in enumerate(zip(inner.lists.offsets.tolist(),
                                          inner.lists.sizes.tolist())):
        data_c = inner.sorted_data[start:start + size, :dim]
        ids_c = inner.lists.ids[start:start + size].long()
        norm_c = inner.sorted_norms[start:start + size]
        dots = pairwise._gemm(qf, data_c, torch.float32)
        dist = torch.sqrt(torch.clamp_min(qnorm[:, None] + norm_c[None, :] - 2.0 * dots, 0.0))
        adj[:, ids_c] |= (dist <= eps) & needed[:, c][:, None]
    return adj, adj.sum(1, dtype=torch.int32)
