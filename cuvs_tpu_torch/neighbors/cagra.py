"""CAGRA: fixed-degree graph ANN index — port of ``cuvs_tpu.neighbors.cagra``.

``cuvs::neighbors::cagra`` (cagra.hpp; build dispatch cagra_build.cuh:2206-2334;
single-CTA search search_single_cta_jit.cuh:112-378). Defaults mirror the
reference: intermediate_graph_degree=128, graph_degree=64, itopk_size=64,
search_width=1, max_iterations auto.

  * build = ``knn_graph`` (exact self-search, partitioned (exact within each
    cluster), nn_descent or IVF-PQ + refine) followed by ``graph_core.optimize``.
  * search = a beam search over a chunk of queries at a time: per query an
    itopk list sorted by distance (ids carry an explored flag in bit 30),
    each step expands the ``search_width`` best unexplored parents, dedups
    their children against the list, the visited ring and each other,
    scores them and merges them as a stable sort would, until no list has
    an unexplored finite entry or the iteration budget ends. On the card a
    chunk of raw rows within the kernel's limits walks in one launch of
    ``ops.cagra_beam`` (one block a query); every other chunk runs the
    PyTorch loop ``_beam_loop`` (dense compares, one batched product, a
    stable sort and one host sync a step), the kernel's plain twin.
  * filtering: filtered nodes route the search but are not returned.
  * stage spans (recorded only under a profiler capture, ``utils/tracing``):
    ``cagra::seeds`` (a chunk's host draw and its copy to the device) and
    ``cagra::beam`` (a chunk's whole walk; the kernel counts its
    ``beam_kernel_queries`` there) under ``cagra::search``, which counts
    ``queries`` and ``beam_steps`` (the steps the loops ran, the most any
    query of a chunk ran);
    ``cagra::knn_graph`` and ``cagra::optimize`` under ``cagra::build``.
  * layouts: raw rows (``Index``), VPQ codes decoded per candidate
    (``compress`` -> ``CompressedIndex``) and packed records holding each
    node's neighbours' int8 vectors (``pack`` -> ``PackedIndex``). One
    search, ``_beam_search``, serves all three; a layout only scores
    candidates, and only raw rows take the kernel.
  * more builds: ``merge`` (physical rebuild or a logical composite),
    ``build_ace`` (one partition on the device at a time) and
    ``build_iterative`` (self-search rounds from a random graph).

Randomness is drawn on the host and handed to the work that uses it: a
search's seeds (``_draw_seeds`` -> ``_search_chunk``), the iterative build's
bootstrap graph (-> ``_iterate``), so a test can feed the reference's draws.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import composite
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.neighbors import graph_core, knn_graph
from cuvs_tpu_torch.neighbors import ivf_pq as ivfpq
from cuvs_tpu_torch.ops import cagra_beam
from cuvs_tpu_torch.preprocessing import quantize
from cuvs_tpu_torch.utils import tracing
from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.tracing import count, span, traced

EXPLORED = 1 << 30  # flag packed into the id payload of the itopk list


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Mirrors cagra::index_params (cagra.hpp:149-255)."""

    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    metric: DistanceType = DistanceType.L2Expanded
    build_algo: str = "auto"  # "auto" | "brute_force" | "partitioned" | "nn_descent" | "ivf_pq"
    ivf_pq_params: Optional[ivfpq.IndexParams] = None
    refine_ratio: float = 2.0
    seed: int = 0
    build_compute_dtype: object = None  # e.g. torch.bfloat16 operands in the graph build
    build_recall_target: object = None  # accepted for parity; selection is exact
    nn_descent_params: object = None  # override the nn_descent build config
    storage_dtype: object = None  # store the dataset as e.g. bfloat16 (norms stay f32)
    guarantee_connectivity: bool = False  # MST-style augmentation (graph_core.cuh:487-644)
    build_n_probes: int = 0  # ivf_pq graph-build probes (0 = auto; from_hnsw_params sets it)

    def __post_init__(self):
        object.__setattr__(self, "metric", normalize_metric(self.metric))

    @staticmethod
    def from_hnsw_params(n_rows: int, dim: int, M: int, ef_construction: int,
                         heuristic: str = "similar_search_performance",
                         metric: DistanceType = DistanceType.L2Expanded) -> "IndexParams":
        """Build params matching a target HNSW index (cagra.hpp:118-147,
        heuristic bodies cagra.cpp:13-56): "similar_search_performance"
        tunes the degrees to the HNSW's recall/QPS curve,
        "same_graph_footprint" matches its size (graph_degree = 2M). Under 1M
        rows the knn graph is built by nn-descent, above by IVF-PQ."""
        h = heuristic.lower()
        if h == "same_graph_footprint":
            graph_degree, intermediate = 2 * M, 3 * M
        elif h == "similar_search_performance":
            graph_degree = 2 + 2 * M // 3
            intermediate = M + M * ef_construction // 256
        else:
            raise ValueError(f"unknown heuristic {heuristic!r}")
        intermediate = max(intermediate, graph_degree)
        if n_rows < 1_000_000:
            from cuvs_tpu_torch.neighbors import nn_descent as nnd

            return IndexParams(
                intermediate_graph_degree=intermediate, graph_degree=graph_degree,
                metric=metric, build_algo="nn_descent",
                nn_descent_params=nnd.IndexParams(
                    graph_degree=intermediate,
                    intermediate_graph_degree=max(2 * intermediate, 32),
                    max_iterations=5 + ef_construction // 16))
        n_lists = max(1, int(math.sqrt(n_rows)))
        return IndexParams(
            intermediate_graph_degree=intermediate, graph_degree=graph_degree, metric=metric,
            build_algo="ivf_pq", ivf_pq_params=ivfpq.IndexParams(n_lists=n_lists, metric=metric),
            build_n_probes=round(2 + math.sqrt(n_lists) / 20 + ef_construction / 16))


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Mirrors cagra::search_params (cagra.hpp:280-355).

    ``visited_size``: the visited ring (the analog of the reference's visited
    hashmap, hashmap.hpp:23-60) holds the last expanded ids, which may not
    re-enter the itopk list. 0 = auto (every expansion the iteration budget
    allows, capped at 256), -1 = off (dedup against the itopk list only)."""

    itopk_size: int = 64
    search_width: int = 1
    max_iterations: int = 0  # 0 = auto
    num_random_samplings: int = 1
    rand_xor_mask: int = 0x128394
    compute_dtype: object = torch.float32
    query_chunk: int = 1024
    visited_size: int = 0


@dataclasses.dataclass
class Index:
    dataset: torch.Tensor  # [n, d]
    dataset_norms: torch.Tensor  # [n] squared L2 of the float32 rows
    graph: torch.Tensor  # [n, graph_degree] int32
    metric: DistanceType = DistanceType.L2Expanded

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dataset.device

    @property
    def data_pack(self):
        return (self.dataset,)


@dataclasses.dataclass
class CompressedIndex:
    """CAGRA index over a VPQ-compressed dataset (cagra.hpp ``compression``;
    vpq_dataset, common.hpp:411). Candidate rows are decoded during the
    search."""

    vq_centers: torch.Tensor  # [vq_n, d]
    vq_codes: torch.Tensor  # [n] int32
    pq_codes: torch.Tensor  # [n, pq_dim] uint8
    pq_codebooks: torch.Tensor  # [pq_dim, book, pq_len]
    dataset_norms: torch.Tensor  # [n] squared norms of the reconstruction
    graph: torch.Tensor  # [n, degree] int32
    metric: DistanceType = DistanceType.L2Expanded

    @property
    def size(self) -> int:
        return self.vq_codes.shape[0]

    @property
    def dim(self) -> int:
        return self.vq_centers.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]

    @property
    def device(self) -> torch.device:
        return self.graph.device

    @property
    def data_pack(self):
        return (self.vq_centers, self.vq_codes, self.pq_codes, self.pq_codebooks)


@dataclasses.dataclass
class PackedIndex:
    """The packed layout: each node's record holds its neighbour ids, the
    neighbours' int8 vectors and their norms, so expanding a parent is one
    wide gather per piece instead of ``deg`` row gathers. It costs
    deg * (d + 4) bytes a node (8.4 GB of child vectors at 1M x 128 x 64).

    ``child_vecs`` splits the [n, deg, d] child array along the neighbour
    axis into pieces of at most ``pack``'s ``_piece_bytes`` (2 GiB by
    default: the reference's answer to a fragmented 16 GB TPU memory,
    cagra.py:223-231; kept so files and results match). A piece may hold
    padded tail rows past n (``pack``'s gather blocks); they are never read.
    """

    graph: torch.Tensor  # [n, deg] int32
    child_vecs: tuple  # tuple of [n (+ pad), deg_i, d] int8, sum(deg_i) == deg
    child_norms: torch.Tensor  # [n, deg] f32 squared norms of the f32 rows
    dataset_int8: torch.Tensor  # [n, d] int8 (the seeds' rows)
    dataset_norms: torch.Tensor  # [n] f32
    scale: torch.Tensor  # [] f32 int8 quantization scale
    metric: DistanceType = DistanceType.L2Expanded

    @property
    def size(self) -> int:
        return self.graph.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset_int8.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]

    @property
    def device(self) -> torch.device:
        return self.graph.device


def pack(index: Index, _blk: int = 0, _piece_bytes: int = 2 << 30) -> PackedIndex:
    """Repack a CAGRA index for serving from packed records (see PackedIndex).

    int8 codes are ``clip(round(x / scale), -127, 127)`` with ``scale =
    max(max|x|, 1e-30) / 127``, both divisions by tensors (a CUDA division by
    a Python scalar multiplies by the reciprocal and would round otherwise).
    The child array is gathered block by block into preallocated pieces:
    blocks of ~1 GB (``_blk`` rows when given; else a divisor of n near that
    size, so no padded tail), pieces of at most ``_piece_bytes``. The tail of
    the last block, when there is one, holds row 0's vector as the
    reference's zero-padded graph gives it."""
    if index.metric not in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                            DistanceType.InnerProduct):
        raise ValueError("packed search supports L2/IP metrics")
    x, g = index.dataset, index.graph
    n, deg = g.shape
    d = x.shape[1]
    dev = x.device
    amax = torch.clamp_min(x.abs().max(), 1e-30)  # in the storage dtype, as the reference
    scale = (amax / torch.full_like(amax, 127.0)).float()
    x8 = torch.empty((n, d), dtype=torch.int8, device=dev)
    qblk = max(1, min(n, (256 << 20) // max(4 * d, 1)))  # ~256 MB f32 transient
    for s in range(0, n, qblk):
        x8[s:s + qblk] = torch.clamp(torch.round(x[s:s + qblk].float() / scale),
                                     -127, 127).to(torch.int8)
    child_norms = index.dataset_norms[g.long()]
    deg_i = max(1, min(deg, _piece_bytes // max(n * d, 1)))
    blk = _blk or max(1, min(n, (1 << 30) // max(deg_i * d, 1)))
    if not _blk:
        for cand in range(blk, max(blk // 4, 0), -1):
            if n % cand == 0:
                blk = cand
                break
    nb = -(-n // blk)
    pieces = []
    for off in range(0, deg, deg_i):
        w = min(deg_i, deg - off)
        piece = torch.empty((nb * blk, w, d), dtype=torch.int8, device=dev)
        for s in range(0, nb * blk, blk):
            e = min(s + blk, n)
            piece[s:e] = x8[g[s:e, off:off + w].long()]
            if e < s + blk:
                piece[e:s + blk] = x8[0]
        pieces.append(piece)
    return PackedIndex(graph=g, child_vecs=tuple(pieces), child_norms=child_norms,
                       dataset_int8=x8, dataset_norms=index.dataset_norms, scale=scale,
                       metric=index.metric)


def compress(index: Index, vq_n_centers: int = 256, pq_dim: int = 0, pq_bits: int = 8,
             seed: int = 0) -> CompressedIndex:
    """Replace the raw rows by VPQ codes (cagra_build.cuh:2311 vpq_build);
    the graph is kept as it is. The quantizer trains on the index's device."""
    vpq = quantize.vpq_train(index.dataset, vq_n_centers=vq_n_centers, pq_dim=pq_dim,
                      pq_bits=pq_bits, seed=seed)
    return _compress_with(index, vpq)


def _compress_with(index: Index, vpq) -> CompressedIndex:
    """``compress`` given a trained VPQ quantizer: codes, and the norms of
    the reconstruction."""
    vq_codes, pq_codes = quantize.vpq_encode(vpq, index.dataset)
    recon = quantize.vpq_decode(vpq, vq_codes, pq_codes)
    return CompressedIndex(vq_centers=vpq.vq_centers, vq_codes=vq_codes, pq_codes=pq_codes,
                           pq_codebooks=vpq.pq.codebooks, dataset_norms=pairwise.row_norms(recon),
                           graph=index.graph, metric=index.metric)


@traced("cagra::build")
def build(dataset, params: Optional[IndexParams] = None, device=None, **kw) -> Index:
    """knn graph -> optimize -> index (cagra_build.cuh:2206). Host data goes
    to ``device`` (None: the CUDA card)."""
    if params is None:
        params = IndexParams(**kw)
    dataset = _on_device(dataset, device)
    n = dataset.shape[0]
    ideg = min(params.intermediate_graph_degree, n - 1)
    gdeg = min(params.graph_degree, ideg)
    with span("cagra::knn_graph"):
        neighbors, _ = knn_graph.build_knn_graph(
            dataset, ideg, metric=params.metric, algo=params.build_algo,
            ivf_pq_params=params.ivf_pq_params, refine_ratio=params.refine_ratio,
            seed=params.seed, compute_dtype=params.build_compute_dtype,
            recall_target=params.build_recall_target,
            nn_descent_params=params.nn_descent_params, n_probes=params.build_n_probes)
    with span("cagra::optimize"):
        graph = graph_core.optimize(
            neighbors, gdeg, guarantee_connectivity=params.guarantee_connectivity,
            dataset=dataset if params.guarantee_connectivity else None)
    return from_graph(dataset, graph, metric=params.metric, storage_dtype=params.storage_dtype)


def from_graph(dataset, graph, metric=DistanceType.L2Expanded, storage_dtype=None,
               device=None) -> Index:
    """Assemble an index from an existing graph (update_graph semantics). The
    norms come from the float32 rows, before any ``storage_dtype`` cast."""
    dataset = _on_device(dataset, device)
    norms = pairwise.row_norms(dataset)
    if storage_dtype is not None:
        dataset = dataset.to(storage_dtype)
    return Index(dataset=dataset, dataset_norms=norms,
                 graph=_on_device(graph, dataset.device).to(torch.int32),
                 metric=normalize_metric(metric))


def _decode_rows(data_pack, ids):
    """Rows for candidate ids from raw storage or VPQ codes: the coarse
    centre plus each subspace's codebook row (indexed by the long codes, no
    one-hot), cut to d."""
    if len(data_pack) == 1:
        return data_pack[0][ids]
    vq_centers, vq_codes, pq_codes, codebooks = data_pack
    c = pq_codes[ids].long()  # [..., pq_dim]
    rec = codebooks[torch.arange(codebooks.shape[0], device=c.device), c]  # [..., pq_dim, len]
    rec = rec.reshape(c.shape[:-1] + (-1,))
    return vq_centers[vq_codes[ids].long()] + rec[..., :vq_centers.shape[1]]


def _distances_to(data_pack, dataset_norms, q, qnorm, ids, metric, compute_dtype):
    """Batched query -> node distances (min-space). q [B,d], ids [B,C] -> [B,C].
    A bf16 ``compute_dtype`` rounds both operands and multiplies the rounded
    values in float32 (pairwise._gemm's convention)."""
    ids = ids.long()
    vecs = _decode_rows(data_pack, ids).to(compute_dtype).float()  # [B, C, d]
    dots = torch.bmm(vecs, q.to(compute_dtype).float()[:, :, None])[:, :, 0]
    if metric == DistanceType.InnerProduct:
        return -dots
    return torch.clamp_min(qnorm[:, None] + dataset_norms[ids] - 2.0 * dots, 0.0)


def _draw_seeds(n: int, B: int, n_seeds: int, seed: int, start: int) -> torch.Tensor:
    """The random entry points [B, n_seeds] of the chunk at query ``start``:
    drawn on the host from a generator seeded by (seed, start), so every
    device searches from the same ids (the reference folds ``start`` into
    its key, cagra.py:580)."""
    gen = torch.Generator()
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | int(start))
    return torch.randint(0, n, (B, n_seeds), generator=gen, dtype=torch.int32)


def _beam_search(seed_d, seeds, graph, qids, prefilter, score_children, k: int, itopk: int,
                 search_width: int, max_iter: int, vis_size: int, metric, walk=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The beam search shared by every layout, from the ``seeds`` [B, n_seeds]
    and their min-space distances ``seed_d``. ``score_children(parents [B, W],
    children [B, W * deg])`` scores the children of the expanded parents
    (invalid parents are 0 and their children -1; scores of those are
    ignored). The steps run in ``_beam_loop``, or in ``walk(state_v,
    state_id) -> (state_v, state_id, counts)`` where one is given (the card's
    kernel, ``ops.cagra_beam``). Returns (distances [B, k], ids [B, k] int32)."""
    dev = seed_d.device
    n = graph.shape[0]
    L = itopk
    n_seeds = seeds.shape[1]
    # identical seeds would be returned twice: every seed equal to an earlier one is +inf
    earlier = torch.ones((n_seeds, n_seeds), dtype=torch.bool, device=dev).tril(-1)
    s_dup = ((seeds[:, :, None] == seeds[:, None, :]) & earlier).any(2)
    seed_d = torch.where(s_dup, float("inf"), seed_d)
    # the itopk list stays sorted ascending; merges are stable key+payload sorts
    sv, so = torch.sort(seed_d, dim=1, stable=True)
    state_v, state_id = sv[:, :L], torch.gather(seeds, 1, so)[:, :L]

    with span("cagra::beam"):
        if walk is None:
            state_v, state_id, it, _ = _beam_loop(state_v, state_id, graph, score_children, L,
                                                  search_width, max_iter, vis_size)
        else:
            state_v, state_id, counts = walk(state_v, state_id)
            # the steps the loop would run: read from the card only under a capture
            it = int(counts[:, 0].max()) if tracing.recording() else 0
    count("beam_steps", it)

    raw_id = state_id & (EXPLORED - 1)
    out_v = torch.where(state_id >= 0, state_v, float("inf"))
    mask = filt.passes(prefilter, qids[:, None], torch.clamp(raw_id, 0, n - 1))
    if mask is None:  # the list is already sorted
        out_ids, out_d = raw_id[:, :k], out_v[:, :k]
    else:
        out_d, order = torch.sort(torch.where(mask, out_v, float("inf")), dim=1, stable=True)
        out_ids, out_d = torch.gather(raw_id, 1, order)[:, :k], out_d[:, :k]
    if metric == DistanceType.InnerProduct:
        out_d = -out_d
    if metric == DistanceType.L2SqrtExpanded:
        out_d = torch.where(torch.isfinite(out_d), torch.sqrt(torch.clamp_min(out_d, 0.0)), out_d)
    return out_d, out_ids


def _beam_loop(state_v, state_id, graph, score_children, itopk: int, search_width: int,
               max_iter: int, vis_size: int):
    """The beam search's steps over the sorted lists (``state_v``, ``state_id``
    [B, <= itopk], which grow to ``itopk`` entries): each expands the
    ``search_width`` best unexplored parents, dedups their children against
    the list, the visited ring and each other by dense compares, scores them
    and merges them by a stable sort; until no list has an unexplored finite
    entry (one host sync a step) or ``max_iter`` steps. Returns (state_v,
    state_id, the steps run, counts [B, 3] int32: each query's steps,
    expanded parents and scored children)."""
    dev = state_v.device
    deg = graph.shape[1]
    B = state_v.shape[0]
    L, W = itopk, search_width
    C = W * deg  # candidates per iteration
    # visited ring: the last vis_size expanded ids; -2 never matches an id or -1
    vis = torch.full((B, max(vis_size, 1)), -2, dtype=torch.int32, device=dev)
    c_earlier = torch.ones((C, C), dtype=torch.bool, device=dev).tril(-1)
    slots = torch.arange(W, device=dev)
    counts = torch.zeros((B, 3), dtype=torch.int32, device=dev)

    def unexplored_finite(state_v, state_id):
        return (state_id >= 0) & ((state_id & EXPLORED) == 0) & torch.isfinite(state_v)

    it = 0
    unexplored = unexplored_finite(state_v, state_id)
    while it < max_iter and bool(unexplored.any()):
        raw_id = state_id & (EXPLORED - 1)
        # the W best unexplored parents: the first W unexplored slots (cumsum rank)
        rank = torch.cumsum(unexplored.to(torch.int32), 1)
        sel = unexplored & (rank <= W)
        slot = torch.where(sel, rank - 1, W).long()
        parent_ids = torch.full((B, W + 1), -1, dtype=torch.int32, device=dev).scatter_(
            1, slot, torch.where(sel, raw_id, -1))[:, :W]
        parent_valid = parent_ids >= 0
        state_id = torch.where(sel, state_id | EXPLORED, state_id)
        if vis_size > 0:
            pos = (it * W + slots) % vis_size
            vis[:, pos] = torch.where(parent_valid, parent_ids, -2)

        safe_p = torch.where(parent_valid, parent_ids, 0)
        children = graph[safe_p.long()].reshape(B, C)
        children = torch.where(parent_valid.repeat_interleave(deg, 1), children, -1)
        # dedup against the itopk list, the visited ring and earlier candidates
        invalid = (children < 0) | (children[:, :, None] == raw_id[:, None, :]).any(2)
        invalid |= ((children[:, :, None] == children[:, None, :]) & c_earlier).any(2)
        if vis_size > 0:
            invalid |= (children[:, :, None] == vis[:, None, :]).any(2)
        cand_d = torch.where(invalid, float("inf"),
                             score_children(safe_p, torch.clamp_min(children, 0)))
        counts += torch.stack([unexplored.any(1), parent_valid.sum(1), (~invalid).sum(1)],
                              1).to(torch.int32)

        mv, order = torch.sort(torch.cat([state_v, cand_d], 1), dim=1, stable=True)
        mid = torch.gather(torch.cat([state_id, children], 1), 1, order)
        state_v, state_id = mv[:, :L], mid[:, :L]
        it += 1
        unexplored = unexplored_finite(state_v, state_id)
    return state_v, state_id, it, counts


def _search_chunk(data_pack, dataset_norms, graph, queries, qids, prefilter, seeds, k: int,
                  itopk: int, search_width: int, max_iter: int, vis_size: int, metric,
                  compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search of one chunk of queries [B, d] from ``seeds`` [B, n_seeds]
    over raw rows or VPQ codes (``data_pack``), scoring candidates by row id.
    On the card, raw rows within the kernel's limits (``cagra_beam.fits``)
    take the kernel, one launch for the chunk's whole walk; other chunks run
    the PyTorch loop. Returns (distances [B, k], ids [B, k] int32)."""
    qf = queries.float()
    qnorm = (qf * qf).sum(1)
    seeds = seeds.to(dataset_norms.device, torch.int32)

    def score(parents, children):
        return _distances_to(data_pack, dataset_norms, queries, qnorm, children, metric,
                             compute_dtype)

    walk = None
    if (graph.is_cuda and seeds.shape[1] >= itopk
            and cagra_beam.fits(data_pack, graph, itopk, search_width, vis_size, metric,
                                compute_dtype)):
        def walk(state_v, state_id):
            return cagra_beam.beam_search(data_pack[0], dataset_norms, graph, queries, qnorm,
                                          state_v, state_id, search_width, max_iter, vis_size,
                                          metric, compute_dtype)

    seed_d = _distances_to(data_pack, dataset_norms, queries, qnorm, seeds, metric,
                           compute_dtype)
    return _beam_search(seed_d, seeds, graph, qids, prefilter, score, k, itopk, search_width,
                        max_iter, vis_size, metric, walk)


def _search_chunk_packed(graph, child_vecs, child_norms, dataset_int8, dataset_norms, scale,
                         queries, qids, prefilter, seeds, k: int, itopk: int,
                         search_width: int, max_iter: int, vis_size: int, metric,
                         compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over the packed layout: the same traversal as
    ``_search_chunk``; the children's int8 vectors and norms come from the
    parent's packed record (one wide gather per piece) instead of one row
    each. The scale is folded into the query (``q / scale``, a tensor
    division) and restored on the dots (``dots * scale^2``)."""
    B = queries.shape[0]
    qf = queries.float()
    qnorm = (qf * qf).sum(1)
    qc = (qf / scale).to(compute_dtype).float()[:, :, None]
    s2 = scale * scale
    seeds = seeds.to(graph.device, torch.int32)

    def from_dots(dots, norms_rows):
        real = dots * s2
        if metric == DistanceType.InnerProduct:
            return -real
        return torch.clamp_min(qnorm[:, None] + norms_rows - 2.0 * real, 0.0)

    def score(parents, children):
        p = parents.long()
        # pieces split the neighbour axis in column order: concat rebuilds [B, W, deg, d]
        cvecs = torch.cat([cv[p] for cv in child_vecs], 2).reshape(B, children.shape[1], -1)
        dots = torch.bmm(cvecs.to(compute_dtype).float(), qc)[:, :, 0]
        return from_dots(dots, child_norms[p].reshape(B, -1))

    s = seeds.long()
    seed_d = from_dots(torch.bmm(dataset_int8[s].to(compute_dtype).float(), qc)[:, :, 0],
                       dataset_norms[s])
    return _beam_search(seed_d, seeds, graph, qids, prefilter, score, k, itopk, search_width,
                        max_iter, vis_size, metric)


def _plan(params: SearchParams, k: int) -> Tuple[int, int, int]:
    """(itopk, max_iter, vis_size) of a search (search_plan.cuh:113-260)."""
    itopk = max(params.itopk_size, k)
    max_iter = params.max_iterations or max(10, itopk // max(params.search_width, 1) + 10)
    vis_size = params.visited_size or min(256, max(
        32, 1 << (max_iter * params.search_width - 1).bit_length()))
    if params.visited_size < 0:
        vis_size = -1
    return itopk, max_iter, vis_size


@traced("cagra::search")
def search(index, queries, k: int, params: Optional[SearchParams] = None,
           prefilter: Optional[filt.Prefilter] = None, seed: int = 0, **kw
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy beam search (search_single_cta_jit.cuh analog) over an
    ``Index``, a ``CompressedIndex`` or a ``PackedIndex``. Returns
    (distances [nq, k], neighbors [nq, k] int32). Queries follow the index."""
    if params is None:
        params = SearchParams(**kw)
    if prefilter is None:
        prefilter = filt.no_filter()
    queries = torch.as_tensor(queries, device=index.device)
    nq = queries.shape[0]
    itopk, max_iter, vis_size = _plan(params, k)
    n_seeds = max(itopk, params.num_random_samplings * itopk)
    chunk = int(min(params.query_chunk, max(1, nq)))
    count("queries", nq)
    outs_d, outs_i = [], []
    for s in range(0, nq, chunk):
        q = queries[s:s + chunk]
        qids = torch.arange(s, s + q.shape[0], device=index.device)
        with span("cagra::seeds"):
            seeds = _draw_seeds(index.size, q.shape[0], n_seeds, seed, s).to(index.device)
        plan = (int(k), int(itopk), int(params.search_width), int(max_iter), int(vis_size),
                index.metric, params.compute_dtype)
        if isinstance(index, PackedIndex):
            d, i = _search_chunk_packed(index.graph, index.child_vecs, index.child_norms,
                                        index.dataset_int8, index.dataset_norms, index.scale,
                                        q, qids, prefilter, seeds, *plan)
        else:
            d, i = _search_chunk(index.data_pack, index.dataset_norms, index.graph, q, qids,
                                 prefilter, seeds, *plan)
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d), torch.cat(outs_i)


def _rank_insert_reverse(graph, dataset_f32, rows, ins_ids, ins_valid, metric=DistanceType.L2Expanded):
    """Rank-based reverse-edge insertion (add_nodes.cuh:24-96 semantics).

    For each affected row t (``rows``, each with up to max_ins candidate
    inserts): the distances of t's current edges and of the candidates are
    recomputed, the combined list sorted by the index metric and the best
    ``degree`` kept — a new node displaces an edge only when it ranks above
    it."""
    deg = graph.shape[1]
    rows = rows.long()
    tvec = dataset_f32[rows]  # [R, d]
    cur = graph[rows]  # [R, deg]
    cand = torch.cat([cur, torch.where(ins_valid, ins_ids, 0).to(cur.dtype)], 1)
    cvec = dataset_f32[cand.long()]  # [R, deg+max_ins, d]
    if metric == DistanceType.InnerProduct:
        d2 = -torch.einsum("rcd,rd->rc", cvec, tvec)  # min-space IP rank
    else:
        d2 = ((cvec - tvec[:, None, :]) ** 2).sum(2)
    # invalid inserts and duplicate candidates rank last
    valid = torch.cat([torch.ones_like(cur, dtype=torch.bool), ins_valid], 1)
    Cn = cand.shape[1]
    earlier = torch.ones((Cn, Cn), dtype=torch.bool, device=cand.device).tril(-1)
    dup = ((cand[:, :, None] == cand[:, None, :]) & earlier).any(2)
    d2 = torch.where(valid & ~dup, d2, float("inf"))
    order = torch.argsort(d2, dim=1, stable=True)[:, :deg]
    return torch.gather(cand, 1, order)


def extend(index: Index, new_vectors, params: Optional[SearchParams] = None) -> Index:
    """Incremental insert (add_nodes.cuh:24 semantics).

    Each new node CAGRA-searches 2*degree neighbours and keeps the best
    ``degree`` as forward edges; it is then offered as a reverse edge to all
    of them, and each target row takes its offers by distance rank against
    its existing edges (at most 8 offers a row), so repeated extends keep
    edge quality instead of eroding the tail slots."""
    new_vectors = _on_device(new_vectors, index.device).to(index.dataset.dtype)
    deg = index.graph_degree
    n_old = index.size
    dev = index.device
    _, nbrs = search(index, new_vectors.float(), min(2 * deg, n_old), params)
    fwd = nbrs[:, :deg].to(torch.int32)
    n_new = new_vectors.shape[0]
    new_ids = torch.arange(n_old, n_old + n_new, dtype=torch.int32, device=dev)
    dataset = torch.cat([index.dataset, new_vectors])

    # offers grouped per target row (stable), slotted by their rank in the group
    pairs_t = fwd.reshape(-1)
    pairs_u = new_ids.repeat_interleave(deg)
    rows, inv = torch.unique(pairs_t, sorted=True, return_inverse=True)
    order = torch.argsort(inv, stable=True)
    inv_s = inv[order]
    first = torch.ones_like(inv_s, dtype=torch.bool)
    first[1:] = inv_s[1:] != inv_s[:-1]
    idx = torch.arange(inv_s.shape[0], device=dev)
    group_start = torch.cummax(torch.where(first, idx, 0), 0).values
    slot = idx - group_start
    max_ins = min(8, int(slot.max()) + 1)
    keep = slot < max_ins
    R = rows.shape[0]
    ins_ids = torch.zeros((R, max_ins), dtype=torch.int32, device=dev)
    ins_valid = torch.zeros((R, max_ins), dtype=torch.bool, device=dev)
    ins_ids[inv_s[keep], slot[keep]] = pairs_u[order][keep]
    ins_valid[inv_s[keep], slot[keep]] = True

    graph_old = index.graph.clone()
    graph_old[rows.long()] = _rank_insert_reverse(graph_old, dataset.float(), rows, ins_ids,
                                                  ins_valid, index.metric)
    return from_graph(dataset, torch.cat([graph_old, fwd]), metric=index.metric)


def merge(indexes, datasets=None, strategy: str = "physical",
          params: Optional[IndexParams] = None):
    """Merge CAGRA indexes (cagra.hpp:2477-2501 MergeStrategy). "physical"
    rebuilds over the concatenated ``dataset``s; any other strategy returns
    the logical composite view (``composite.merge``), which searches every
    child and merges their top-k."""
    if strategy == "physical":
        data = torch.cat([ix.dataset for ix in indexes])
        return build(data, params) if params is not None else build(data)
    return composite.merge(sys.modules[__name__], indexes, strategy="logical")


@dataclasses.dataclass(frozen=True)
class AceParams:
    """Mirrors cagra::ace_params (cagra.hpp:41-101): partitioned builds for
    graphs larger than device memory."""

    npartitions: int = 4
    overlap: int = 2  # core + (overlap - 1) halo partitions per point
    build_dir: Optional[str] = None  # spill the graph to disk (a .npy memmap)
    intermediate_graph_degree: int = 64
    graph_degree: int = 32
    seed: int = 0


def build_ace(dataset, params: Optional[AceParams] = None, device=None, **kw) -> Index:
    """ACE (Augmented Core Extraction) build (cagra_build.cuh:77-1028).

    Balanced k-means cuts the rows into ``npartitions``; each row's core
    partition is its nearest, and it is a halo member of its next
    ``overlap - 1``. Each partition's sub-graph is built over its core and
    halo members, so edges near the borders stay right, and only core rows
    are written to the global graph (host memory, or ``build_dir``'s
    ``ace_graph.npy`` memmap). The device holds one partition's build at a
    time: each sub-index is freed before the next. Host data goes to
    ``device`` (None: the CUDA card)."""
    from cuvs_tpu_torch.cluster import kmeans_balanced

    if params is None:
        params = AceParams(**kw)
    x = _on_device(dataset, device).float()
    P = max(2, params.npartitions)
    centers = kmeans_balanced.fit(x, P, seed=params.seed)
    graph = _ace_assemble(x, _ace_ranks(x, centers, params.overlap), P, params)
    return from_graph(x, np.array(graph))


def _ace_ranks(x: torch.Tensor, centers: torch.Tensor, overlap: int) -> np.ndarray:
    """Each row's ``overlap`` nearest partitions [n, overlap], ordered as the
    reference's host ``np.argsort`` orders them."""
    d2c = pairwise.pairwise_distance(x, centers).cpu().numpy()
    return np.argsort(d2c, axis=1)[:, :overlap]


def _ace_assemble(x: torch.Tensor, ranks: np.ndarray, P: int, params: AceParams) -> np.ndarray:
    """The global graph [n, graph_degree] int32 from one ``build`` per
    partition (over core + halo rows; core rows written, remapped to global
    ids). A partition of at most ``graph_degree`` members links its core
    rows to its members, repeated."""
    n = x.shape[0]
    deg = params.graph_degree
    if params.build_dir:
        os.makedirs(params.build_dir, exist_ok=True)
        graph = np.lib.format.open_memmap(os.path.join(params.build_dir, "ace_graph.npy"),
                                          mode="w+", dtype=np.int32, shape=(n, deg))
    else:
        graph = np.zeros((n, deg), np.int32)
    for p in range(P):
        core = np.where(ranks[:, 0] == p)[0]
        halo = np.where((ranks[:, 1:] == p).any(axis=1))[0]
        members = np.concatenate([core, halo])
        if len(members) <= deg:
            graph[core] = np.resize(members, (len(core), deg))
            continue
        sub = build(x[torch.from_numpy(members).to(x.device)], IndexParams(
            intermediate_graph_degree=min(params.intermediate_graph_degree, len(members) - 1),
            graph_degree=min(deg, len(members) - 1), seed=params.seed))
        core_rows = sub.graph[:len(core)].cpu().numpy()  # local ids over `members`
        del sub
        remapped = members[core_rows]
        if remapped.shape[1] < deg:
            remapped = np.pad(remapped, ((0, 0), (0, deg - remapped.shape[1])), mode="edge")
        graph[core] = remapped
    if params.build_dir:
        graph.flush()
    return graph


def build_iterative(dataset, graph_degree: int = 32, intermediate_graph_degree: int = 64,
                    n_rounds: int = 3, metric=DistanceType.L2Expanded, seed: int = 0,
                    device=None) -> Index:
    """Iterative CAGRA build (cagra_build.cuh:2015 iterative-search path): a
    random regular bootstrap graph, then ``n_rounds`` of self-search on the
    current graph and re-optimization. For when neither an exact self-search
    nor nn-descent fits the budget. The bootstrap graph is drawn on the host
    from a ``torch.Generator`` seeded by ``seed`` (the same graph on every
    device). Host data goes to ``device`` (None: the CUDA card)."""
    x = _on_device(dataset, device)
    n = x.shape[0]
    ideg = min(intermediate_graph_degree, n - 1)
    gdeg = min(graph_degree, ideg)
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    graph = torch.randint(0, n, (n, gdeg), generator=gen, dtype=torch.int32)
    return _iterate(x, graph, ideg, n_rounds, metric, seed)


def _iterate(x: torch.Tensor, graph, ideg: int, n_rounds: int, metric, seed: int) -> Index:
    """``build_iterative``'s rounds from a bootstrap ``graph``: each row
    searches k = ideg + 1 neighbours (itopk max(2 ideg, 64), seed + round),
    drops itself, and the knn graph is pruned to the bootstrap's degree."""
    n = x.shape[0]
    gdeg = graph.shape[1]
    index = from_graph(x, graph, metric=metric)
    qf = x.float()
    rows = torch.arange(n, dtype=torch.int32, device=x.device)[:, None]
    for r in range(n_rounds):
        d, nbrs = search(index, qf, min(ideg + 1, n - 1), itopk_size=max(2 * ideg, 64),
                         seed=seed + r)
        nbrs = nbrs.to(torch.int32)
        dd = torch.where(nbrs == rows, float("inf"), d)
        knn = torch.gather(nbrs, 1, torch.argsort(dd, dim=1, stable=True)[:, :ideg])
        index = from_graph(x, graph_core.optimize(knn, gdeg), metric=metric)
    return index
