"""NN-descent: iterative k-NN graph refinement — port of
``cuvs_tpu.neighbors.nn_descent``.

``cuvs::neighbors::nn_descent`` (nn_descent.hpp:61-76: graph_degree=64,
intermediate_graph_degree=128, max_iterations=20, termination_threshold=1e-4)
as the reference reformulates it: each round, every node samples S of its
(2K)^2 two-hop candidates through the union of forward and reverse edges,
scores them with one batched product, and merges them into its sorted
K-list. The random draws (the initial graph, each chunk's picks) come from a
``torch.Generator`` seeded from ``seed``, apart from the deterministic work
that uses them: ``_expand_round`` takes its picks from a callable, so a test
can feed it the reference's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors.graph_core import _is_member, _reverse_graph
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Mirrors nn_descent::index_params (nn_descent.hpp:61-76)."""

    graph_degree: int = 64
    intermediate_graph_degree: int = 128
    max_iterations: int = 20
    termination_threshold: float = 1e-4
    metric: DistanceType = DistanceType.L2Expanded
    sample_per_node: int = 0  # 0 = auto (~2x degree)
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "metric", normalize_metric(self.metric))


def _expand_round(dataset, norms, graph, graph_d, adj, picks: Callable, chunk: int,
                  compute_dtype) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One expansion round over row chunks. graph/graph_d: [n, K] sorted by
    distance; ``adj`` [n, 2K] the union of forward and reverse edges (the
    information the reference's new/old local join uses, nn_descent.cuh:599).

    ``picks(row0, B)`` returns the chunk's [B, S] sample positions in
    [0, 4K^2). Returns the new graph, its distances and the count of changed
    slots."""
    n, K = graph.shape
    out_i, out_d, changed = [], [], 0
    for c0 in range(0, n, chunk):
        gu, gdu, au = graph[c0:c0 + chunk], graph_d[c0:c0 + chunk], adj[c0:c0 + chunk]
        B = gu.shape[0]
        rows = torch.arange(c0, c0 + B, device=graph.device)
        # pick p of the flat two-hop list adj[adj[u]] is adj[adj[u, p // 2K], p % 2K]
        p = picks(c0, B).long()
        hop = torch.gather(au, 1, p // (2 * K)).long()
        cand = adj[hop, p % (2 * K)]  # [B, S]
        # drop self, current neighbours and repeats among the candidates
        self_hit = cand == rows[:, None]
        in_graph = _is_member(cand, gu)
        c_idx = torch.argsort(cand, dim=1, stable=True)
        c_sorted = torch.gather(cand, 1, c_idx)
        dup_adj = torch.zeros_like(cand, dtype=torch.bool)
        dup_adj[:, 1:] = c_sorted[:, 1:] == c_sorted[:, :-1]
        dup = torch.zeros_like(dup_adj).scatter_(1, c_idx, dup_adj)
        invalid = self_hit | in_graph | dup

        q = dataset[rows].to(compute_dtype).float()
        vecs = dataset[cand.long()].to(compute_dtype).float()
        dots = torch.bmm(vecs, q[:, :, None])[:, :, 0]
        cd = torch.clamp_min(norms[rows][:, None] + norms[cand.long()] - 2.0 * dots, 0.0)
        cd = torch.where(invalid, float("inf"), cd)

        new_d, tl = topk(torch.cat([gdu, cd], 1), K, True)
        new_i = torch.gather(torch.cat([gu, cand.to(gu.dtype)], 1), 1, tl)
        changed += int((new_i != gu).sum())
        out_i.append(new_i)
        out_d.append(new_d)
    return torch.cat(out_i), torch.cat(out_d), changed


def _init_dists(dataset_f, graph, norms, rows: int) -> torch.Tensor:
    """Distances of the random initial graph, in chunks of ``rows`` (the
    [n, K, d] gather would be tens of GB at 1M rows); self edges are +inf."""
    out = []
    for r0 in range(0, graph.shape[0], rows):
        g = graph[r0:r0 + rows].long()
        r = torch.arange(r0, r0 + g.shape[0], device=graph.device)
        dots = torch.bmm(dataset_f[g], dataset_f[r][:, :, None])[:, :, 0]
        d = torch.clamp_min(norms[r][:, None] + norms[g] - 2.0 * dots, 0.0)
        out.append(torch.where(g == r[:, None], float("inf"), d))
    return torch.cat(out)


def build(dataset, params: Optional[IndexParams] = None, chunk: int = 4096,
          compute_dtype=torch.float32, block_local="auto", device=None, **kw
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the k-NN graph. Returns (graph [n, graph_degree] int32, distances).

    ``block_local`` ("auto" | True | False): "auto" reroutes builds of 4M+
    rows through the block-local join (``all_neighbors``' batched build over
    overlapping balanced partitions, exact per block); False forces the
    expansion rounds at any size. Host data goes to ``device`` (None: the
    CUDA card)."""
    if params is None:
        params = IndexParams(**kw)
    dataset = _on_device(dataset, device)
    n, d = dataset.shape
    dev = dataset.device
    if block_local == "auto":
        block_local = n >= 4_000_000
    if block_local and n > 4 * max(params.graph_degree, 1):
        from cuvs_tpu_torch.neighbors import all_neighbors

        g, gd = all_neighbors.build(dataset, params.graph_degree, all_neighbors.AllNeighborsParams(
            n_clusters=max(4, int(np.ceil(n / 500_000))), overlap_factor=2,
            metric=params.metric, seed=params.seed))
        return g.to(torch.int32), gd
    K = min(params.intermediate_graph_degree, n - 1)
    # coverage of the two-hop neighbourhood per round governs convergence
    S = params.sample_per_node or min(2048, max(16 * K, K * K))
    # bound the [chunk, S, d] candidate-vector gather to ~2 GB
    budget_rows = max(256, (2 * 1024 ** 3) // max(S * d * 4, 1))
    chunk = 1 << (min(chunk, budget_rows).bit_length() - 1)
    chunk = min(chunk, max(8, n))
    norms = pairwise.row_norms(dataset)

    gen = torch.Generator(device=dev)
    gen.manual_seed(params.seed)
    graph = torch.randint(0, n, (n, K), generator=gen, device=dev, dtype=torch.int32)
    init_rows = max(256, min(n, (1 << 30) // max(K * d * 4, 1)))
    init_rows = 1 << (init_rows.bit_length() - 1)
    graph_d = _init_dists(dataset.float(), graph, norms, init_rows)
    order = torch.argsort(graph_d, dim=1, stable=True)
    graph, graph_d = torch.gather(graph, 1, order), torch.gather(graph_d, 1, order)

    def picks(row0, B):
        return torch.randint(0, 4 * K * K, (B, S), generator=gen, device=dev)

    rows_all = torch.arange(n, device=dev, dtype=torch.int32)[:, None]
    for _ in range(params.max_iterations):
        rev, rev_valid = _reverse_graph(graph, K)
        adj = torch.cat([graph, torch.where(rev_valid, rev, rows_all)], 1)  # self = no-op
        graph, graph_d, changed = _expand_round(dataset, norms, graph, graph_d, adj, picks,
                                                chunk, compute_dtype)
        if changed / float(n * K) < params.termination_threshold:
            break
    deg = min(params.graph_degree, K)
    return graph[:, :deg].contiguous(), graph_d[:, :deg].contiguous()
