"""all_neighbors: the k-NN-graph build API with a batched mode — port of
``cuvs_tpu.neighbors.all_neighbors``.

``cuvs::neighbors::all_neighbors`` (all_neighbors.hpp:25-90): single or
batched build. Batched: balanced clusters, each row a member of its
``overlap_factor`` nearest clusters, one exact self-search per cluster, and
a merge of each cluster's lists into the global graph by distance. Device
memory holds one cluster's block at a time.

The reference pads every cluster to one size with copies of its first member
(one compiled program for all clusters); the copies then take slots of real
neighbours in the self-search, and rows near that member end with repeated
ids. The port searches each cluster at its own size and has no copies: the
same merge (``_merge``), on lists without them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


@dataclasses.dataclass(frozen=True)
class AllNeighborsParams:
    """Mirrors all_neighbors_params (all_neighbors.hpp:40-90)."""

    algo: str = "auto"  # "brute_force" | "nn_descent" | "ivf_pq" | "auto"
    n_clusters: int = 1  # 1 = single (non-batched) build
    overlap_factor: int = 2
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "metric", normalize_metric(self.metric))
        if self.n_clusters > 1 and self.overlap_factor >= self.n_clusters:
            raise ValueError("overlap_factor must be < n_clusters")


def _single(dataset, k, params, **kw):
    if params.algo in ("brute_force", "ivf_pq", "auto"):
        from cuvs_tpu_torch.neighbors import knn_graph

        return knn_graph.build_knn_graph(dataset, k, metric=params.metric, algo=params.algo,
                                         seed=params.seed, **kw)
    if params.algo == "nn_descent":
        from cuvs_tpu_torch.neighbors import nn_descent

        return nn_descent.build(dataset, nn_descent.IndexParams(
            graph_degree=k, intermediate_graph_degree=max(2 * k, k + 16),
            metric=params.metric, seed=params.seed))
    raise ValueError(f"unknown algo {params.algo!r}")


def _merge(best_d, best_i, ids, sub_d, sub_l, n_real: int, k_out: int):
    """Merge one cluster's self-search into the global lists (in place).

    ``ids`` maps the cluster's local ids to global ones; the first n_real
    rows of sub_d/sub_l [>= n_real, kk] are its members' distances and local
    ids. Same neighbours found through two clusters are deduped by a two-key
    (id, distance) order — two stable passes, minor key first — that keeps
    each id's best entry; the rows are then re-sorted by distance and their
    first k_out written back."""
    rows = ids[:n_real].long()
    g = ids[sub_l[:n_real].long()]  # local -> global ids [n_real, kk]
    d = torch.where(g == rows[:, None], float("inf"), sub_d[:n_real])  # drop self
    md = torch.cat([best_d[rows], d], 1)
    mi = torch.cat([best_i[rows], g], 1)
    o = torch.argsort(md, dim=1, stable=True)
    o = torch.gather(o, 1, torch.argsort(torch.gather(mi, 1, o), dim=1, stable=True))
    mi_s, md_s = torch.gather(mi, 1, o), torch.gather(md, 1, o)
    dup = torch.zeros_like(mi_s, dtype=torch.bool)
    dup[:, 1:] = mi_s[:, 1:] == mi_s[:, :-1]
    md_s = torch.where(dup, float("inf"), md_s)
    sv, order = torch.sort(md_s, dim=1, stable=True)
    best_d[rows] = sv[:, :k_out]
    best_i[rows] = torch.gather(mi_s, 1, order)[:, :k_out]
    return best_d, best_i


def _partition(xf: torch.Tensor, c: int, overlap: int, seed: int) -> np.ndarray:
    """Each row's ``overlap`` nearest of ``c`` balanced clusters: [n, overlap]
    cluster ids on the host, where the grouping runs."""
    n = xf.shape[0]
    # the partitioner trains on a subsample: c centers need far fewer than n rows
    frac = min(1.0, max(200_000, 64 * c) / max(n, 1))
    centers = kmeans_balanced.fit(xf, c, kmeans_balanced.BalancedParams(
        n_clusters=c, trainset_fraction=frac, seed=seed))
    d2c = (centers * centers).sum(1)[None, :] - 2.0 * xf @ centers.T
    return topk(d2c, overlap, True)[1].cpu().numpy()


def build(dataset, k: int, params: Optional[AllNeighborsParams] = None, device=None,
          **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN graph of the dataset. Returns (neighbors [n, k] int32, distances).

    n_clusters > 1 runs the batched path: per-cluster exact sub-builds over
    overlapping membership, merged by distance. Host data goes to ``device``
    (None: the CUDA card)."""
    if params is None:
        fields = AllNeighborsParams.__dataclass_fields__
        params = AllNeighborsParams(**{k_: v for k_, v in kw.items() if k_ in fields})
        kw = {k_: v for k_, v in kw.items() if k_ not in fields}
    dataset = _on_device(dataset, device)
    if dataset.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        dataset = dataset.float()
    n = dataset.shape[0]
    dev = dataset.device
    if params.n_clusters <= 1:
        return _single(dataset.float(), k, params, **kw)

    c = params.n_clusters
    assign = _partition(dataset.float(), c, params.overlap_factor, params.seed)
    member_lists = [np.where((assign == ci).any(axis=1))[0] for ci in range(c)]

    from cuvs_tpu_torch.neighbors import brute_force as bf

    best_d = torch.full((n, k), float("inf"), device=dev)
    best_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)  # -1 = empty slot
    compute_dtype = kw.pop("compute_dtype", torch.float32)
    recall_target = kw.pop("recall_target", None)
    for members in member_lists:
        n_real = len(members)
        if n_real <= k:
            continue
        ids = torch.from_numpy(members.astype(np.int32)).to(dev)
        sub = dataset[ids.long()]
        sub_d, sub_l = bf.search(bf.build(sub, metric=params.metric), sub, k + 1,
                                 compute_dtype=compute_dtype, recall_target=recall_target)
        best_d, best_i = _merge(best_d, best_i, ids, sub_d, sub_l, n_real, k)
        del sub, sub_d, sub_l
    # a row whose list came up short keeps -1/inf slots; its ids are padded
    # with its own first neighbour (or the next row) so every id is valid
    rows = torch.arange(n, device=dev, dtype=torch.int32)
    first = torch.where(best_i[:, 0] >= 0, best_i[:, 0], (rows + 1) % n)
    best_i = torch.where(best_i >= 0, best_i, first[:, None])
    return best_i, best_d
