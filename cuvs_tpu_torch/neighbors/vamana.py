"""Vamana (DiskANN) graph build: batched inserts and robust prune — port of
``cuvs_tpu.neighbors.vamana``.

``cuvs::neighbors::vamana`` (vamana.hpp:59-76: graph_degree=32,
visited_size=64, alpha=1.2, insert batches growing exponentially up to
max_fraction=0.06 of n, vamana_build.cuh:88-120; GreedySearchKernel
greedy_search.cuh:88; RobustPruneKernel robust_prune.cuh:56). Files are
DiskANN graphs (vamana_serialize.cuh).

Each insert batch runs CAGRA's beam search over the graph built so far, and
RobustPrune is a loop of R steps over the batch's fixed-size candidate
lists. The reverse-edge pass stays on the host in numpy, as in the
reference: its fancy assignments repeat row indices, and numpy's rule of
which write survives keeps the graph the same on every device (an
``index_put_`` with repeated indices has no defined order on CUDA).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import cagra as cagra_mod
from cuvs_tpu_torch.utils.device import as_tensor as _on_device

_HEADER = "<QIIQ"  # file size, max degree, medoid, frozen points


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Mirrors vamana::index_params (vamana.hpp:59-76)."""

    graph_degree: int = 32
    visited_size: int = 64
    alpha: float = 1.2
    max_fraction: float = 0.06
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "metric", normalize_metric(self.metric))


@dataclasses.dataclass
class Index:
    dataset: torch.Tensor  # [n, d] f32
    graph: torch.Tensor  # [n, graph_degree] int32, -1 padded
    medoid: int
    metric: DistanceType = DistanceType.L2Expanded

    @property
    def size(self) -> int:
        return self.dataset.shape[0]


def _robust_prune(cand_ids, cand_d, vectors, cand_vecs, alpha: float, R: int) -> torch.Tensor:
    """RobustPrune (robust_prune.cuh:56) over a batch.

    cand_ids / cand_d [B, C] sorted by distance (-1 / inf invalid); vectors
    [B, d] the points pruned for (unused: the candidates' distances to them
    are ``cand_d``); cand_vecs [B, C, d]. Each of R steps keeps the nearest
    alive candidate (the first at a tie, as ``argmin``) and suppresses every
    candidate v with alpha * d(kept, v) <= d(p, v). Returns the kept ids
    [B, R] int32 (-1 padded)."""
    B, C = cand_ids.shape
    dev = cand_ids.device
    cn = (cand_vecs * cand_vecs).sum(2)
    cc = torch.clamp_min(cn[:, :, None] + cn[:, None, :]
                         - 2.0 * torch.bmm(cand_vecs, cand_vecs.transpose(1, 2)), 0.0)
    alive = torch.isfinite(cand_d) & (cand_ids >= 0)
    kept = torch.full((B, R), -1, dtype=torch.int32, device=dev)
    nk = torch.zeros(B, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)
    for _ in range(R):
        masked = torch.where(alive, cand_d, float("inf"))
        j = torch.argmin(masked, dim=1)
        ok = torch.isfinite(masked[rows, j])
        kept[rows, nk] = torch.where(ok, cand_ids[rows, j].to(torch.int32), -1)
        nk += ok.long()
        alive &= ~(alpha * cc[rows, j] <= cand_d)
        alive[rows, j] = False
    return kept


def _add_reverse_edges(graph: np.ndarray, ids: np.ndarray, kept: np.ndarray) -> None:
    """Each new node's kept targets gain an edge back to it (host numpy, in
    place): offers are grouped by target (stable sort), fill the target's
    free slots first and then replace from the tail; each offered row is
    first sorted descending, so valid ids come first and -1 slots last."""
    R = graph.shape[1]
    src = np.repeat(ids, R)
    dst = kept.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    first = np.concatenate([[True], dst_s[1:] != dst_s[:-1]])
    group_start = np.maximum.accumulate(np.where(first, np.arange(len(dst_s)), 0))
    slot_rank = np.arange(len(dst_s)) - group_start
    free_count = (graph[dst_s] < 0).sum(1)
    free_pos = R - free_count  # the first free slot
    tgt_slot = np.where(slot_rank < free_count, free_pos + slot_rank,
                        R - 1 - np.minimum(slot_rank - free_count, R - 1))
    graph[dst_s] = np.sort(graph[dst_s], axis=1)[:, ::-1]
    graph[dst_s, tgt_slot] = src_s


def build(dataset, params: Optional[IndexParams] = None, device=None, **kw) -> Index:
    """Vamana build (vamana_build.cuh:88-120): a clique over the first
    max(R + 1, 64) rows, then insert batches that double up to max_fraction
    of n. Each batch beam-searches the graph built so far (itopk
    max(visited_size, R), at least 16 iterations), robust-prunes its
    candidates and adds reverse edges. Host data goes to ``device`` (None:
    the CUDA card)."""
    if params is None:
        params = IndexParams(**kw)
    x = _on_device(dataset, device).float()
    dev = x.device
    n = x.shape[0]
    R, L = params.graph_degree, params.visited_size
    medoid = int(torch.argmin(((x - x.mean(0, keepdim=True)) ** 2).sum(1)))

    graph = np.full((n, R), -1, np.int32)
    # the first rows (around the medoid) form a clique of their nearest R
    first = min(max(R + 1, 64), n)
    bf_d = pairwise.pairwise_distance(x[:first], x[:first]).cpu().numpy()
    np.fill_diagonal(bf_d, np.inf)
    m0 = min(R, first - 1)
    graph[:first, :m0] = np.argsort(bf_d, 1)[:, :m0]

    built, batch = first, max(64, first)
    while built < n:
        batch = min(int(batch * 2), max(int(n * params.max_fraction), 256), n - built)
        prefix = cagra_mod.from_graph(
            x[:built], torch.from_numpy(np.where(graph[:built] >= 0, graph[:built], 0)),
            metric=params.metric)
        cd, ci = cagra_mod.search(prefix, x[built:built + batch], min(L, built),
                                  itopk_size=max(L, R), max_iterations=max(16, L // 2),
                                  seed=params.seed)
        ci = ci.to(dev, torch.int32)
        kept = _robust_prune(ci, cd.to(dev), x[built:built + batch],
                             x[torch.clamp(ci, 0, n - 1).long()], params.alpha, R).cpu().numpy()
        ids = np.arange(built, built + batch)
        graph[ids] = kept
        _add_reverse_edges(graph, ids, kept)
        built += batch
    return Index(dataset=x, graph=torch.from_numpy(graph).to(dev), medoid=medoid,
                 metric=params.metric)


def search(index: Index, queries, k: int, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy search over the Vamana graph (DiskANN-style serving): CAGRA's
    beam search, -1 slots pointing at row 0."""
    g = torch.where(index.graph >= 0, index.graph, 0)
    ix = cagra_mod.from_graph(index.dataset, g, metric=index.metric)
    return cagra_mod.search(ix, queries, k, **kw)


def serialize(index: Index, path: str) -> None:
    """DiskANN graph file (vamana_serialize.cuh): [u64 file_size][u32
    max_degree][u32 medoid][u64 num_frozen], then per node [u32 degree]
    [degree x u32 neighbours], written from one array of records."""
    graph = index.graph.cpu().numpy()
    n, R = graph.shape
    degrees = (graph >= 0).sum(1).astype(np.uint32)
    records = np.empty((n, R + 1), np.uint32)
    records[:, 0] = degrees
    records[:, 1:] = graph.astype(np.uint32)
    body = records[np.arange(R + 1)[None, :] <= degrees[:, None]]  # row-major order
    size = struct.calcsize(_HEADER) + body.nbytes
    with open(path, "wb") as f:
        f.write(struct.pack(_HEADER, size, int(degrees.max(initial=0)), index.medoid, 0))
        f.write(body.tobytes())


def deserialize(path: str, dataset, metric=DistanceType.L2Expanded, device=None) -> Index:
    """Read a DiskANN graph file over ``dataset`` (host data goes to
    ``device``, None: the CUDA card)."""
    x = _on_device(dataset, device).float()
    with open(path, "rb") as f:
        raw = f.read()
    size, max_deg, medoid, _ = struct.unpack_from(_HEADER, raw, 0)
    if size != len(raw):
        raise ValueError("corrupt DiskANN graph file (size mismatch)")
    words = np.frombuffer(raw, np.uint32, offset=struct.calcsize(_HEADER))
    n = x.shape[0]
    starts = np.empty(n, np.int64)
    degs = np.empty(n, np.int64)
    pos = 0
    for i in range(n):  # records have their own lengths: walk them
        deg = int(words[pos])
        starts[i], degs[i] = pos + 1, deg
        pos += 1 + deg
    col = np.arange(max_deg)[None, :]
    valid = col < degs[:, None]
    graph = np.full((n, max_deg), -1, np.int32)
    graph[valid] = words[(starts[:, None] + col)[valid]].astype(np.int32)
    return Index(dataset=x, graph=torch.from_numpy(graph).to(x.device), medoid=medoid,
                 metric=normalize_metric(metric))
