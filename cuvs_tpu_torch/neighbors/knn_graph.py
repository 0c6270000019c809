"""k-NN graph construction (CAGRA's build substrate) — port of
``cuvs_tpu.neighbors.knn_graph``.

``cuvs::neighbors::all_neighbors`` backends and CAGRA's build_knn_graph
(cagra_build.cuh:1629, the IVF-PQ path: build, batched self-search, refine
re-rank). ``brute_force`` is the exact tiled self-search (the unfused
``brute_force.search``: matmul + exact selection), ``partitioned`` the
batched ``all_neighbors`` build over overlapping balanced clusters,
``nn_descent`` the expansion rounds, and ``ivf_pq`` an IVF-PQ build + batched
self-search (the fused ``pq_scan`` kernel on the card) + exact refine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.distance.pairwise import normalize_metric
from cuvs_tpu_torch.neighbors import brute_force as bf
from cuvs_tpu_torch.neighbors import ivf_pq as ivfpq
from cuvs_tpu_torch.neighbors import refine as rf
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


def _drop_self(ids: torch.Tensor, dists: torch.Tensor, k: int):
    """Remove each row's self-match and keep k columns.

    ids/dists have k+1 columns; self is usually column 0 but ties can
    reorder, so any column equal to the row id is pushed last by +inf."""
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None]
    d = torch.where(ids == rows, float("inf"), dists)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    return torch.gather(ids, 1, order), torch.gather(d, 1, order)


def build_knn_graph(dataset, k: int, metric="sqeuclidean", algo: str = "auto",
                    query_batch: int = 4096, ivf_pq_params: Optional[ivfpq.IndexParams] = None,
                    refine_ratio: float = 2.0, seed: int = 0, compute_dtype=None,
                    recall_target=None, nn_descent_params=None, n_probes: int = 0,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN graph over the dataset (self-edges removed).

    Returns (neighbors [n, k] int32 sorted by distance, distances [n, k]).
    algo: "brute_force" | "partitioned" | "nn_descent" | "ivf_pq" | "auto" —
    exact below 150k rows, partitioned above (the reference's rule). Host
    data goes to ``device`` (None: the CUDA card)."""
    dataset = _on_device(dataset, device)
    n = dataset.shape[0]
    metric = normalize_metric(metric)
    cd = compute_dtype if compute_dtype is not None else torch.float32
    if algo == "auto":
        algo = "brute_force" if n <= 150_000 else "partitioned"

    if algo == "partitioned":
        from cuvs_tpu_torch.neighbors import all_neighbors

        overlap = 2
        target_rows = 32_768  # padded per-cluster block size
        n_clusters = max(overlap + 1, -(-n * overlap // target_rows))
        return all_neighbors.build(
            dataset, k,
            all_neighbors.AllNeighborsParams(algo="brute_force", n_clusters=n_clusters,
                                             overlap_factor=overlap, metric=metric, seed=seed),
            compute_dtype=cd, recall_target=recall_target)

    if algo == "nn_descent":
        from cuvs_tpu_torch.neighbors import nn_descent

        nd_params = nn_descent_params or nn_descent.IndexParams(
            graph_degree=k, intermediate_graph_degree=max(k + 16, int(k * 1.5)),
            metric=metric, seed=seed)
        return nn_descent.build(dataset, nd_params, compute_dtype=cd)

    if algo == "brute_force":
        index = bf.build(dataset, metric=metric)

        def search(q):
            return bf.search(index, q, k + 1, compute_dtype=cd, recall_target=recall_target)
    elif algo == "ivf_pq":
        if ivf_pq_params is None:
            ivf_pq_params = ivfpq.IndexParams(
                n_lists=max(32, min(4096, int(n ** 0.5))), metric=metric, seed=seed,
                kmeans_trainset_fraction=min(1.0, 100_000 / max(n, 1)))
        index = ivfpq.build(dataset, ivf_pq_params)
        n_cand = int((k + 1) * refine_ratio)
        n_probes = n_probes or max(20, ivf_pq_params.n_lists // 20)

        def search(q):
            _, cand = ivfpq.search(index, q, n_cand, n_probes=n_probes)
            return rf.refine(dataset, q, cand, k + 1, metric=metric)
    else:
        raise ValueError(f"unknown knn graph algo {algo!r}")
    parts = [search(dataset[s:s + query_batch]) for s in range(0, n, query_batch)]
    return _drop_self(torch.cat([i for _, i in parts]), torch.cat([d for d, _ in parts]), k)
