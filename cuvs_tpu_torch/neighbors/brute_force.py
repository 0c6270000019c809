"""Exact brute-force k-NN — port of ``cuvs_tpu.neighbors.brute_force``.

Unfused path (brute_force.hpp, knn_brute_force.cuh:62-267): queries in chunks,
the dataset in column tiles; each [chunk, tile] distance block is one matmul
plus the metric epilogue, prefilters mask it with +inf, and a running top-k
merges the tiles. ``fused=True`` routes unfiltered L2/IP searches to the fused
distance + top-k kernels (``ops.bf_topk``): exact for k <= 64, approximate
(per-lane-bin) with ``recall_target`` set and k <= 128.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils.tracing import traced


@dataclasses.dataclass
class Index:
    """Brute-force index: dataset + precomputed norms, on one device.

    ``q_scale`` (0-d f32 tensor) is set when the dataset is stored
    int8-quantized (``build(..., storage_dtype=torch.int8)``): rows are
    ``round(x / q_scale)`` and dots run in int8 x int8 -> int32, rescaled by
    ``q_scale**2``; norms stay exact f32 from the original data. Pair with
    ``neighbors.refine`` for exact final ranking.
    """

    dataset: torch.Tensor  # [n, d]
    norms: Optional[torch.Tensor]  # [n] squared L2 (L2 family) / L2 (cosine)
    q_scale: Optional[torch.Tensor] = None
    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dataset.device


@traced("brute_force::build")
def build(dataset, metric="sqeuclidean", metric_arg: float = 2.0, storage_dtype=None,
          device=None) -> Index:
    """Build an exact-search index (precomputes row norms for L2/cosine).

    ``storage_dtype=torch.int8`` stores globally-scaled int8 rows (see Index).
    """
    metric = normalize_metric(metric)
    dataset = torch.as_tensor(dataset, device=device)
    if callable(metric) and not isinstance(metric, DistanceType):
        return Index(dataset=dataset, norms=None, metric=metric, metric_arg=metric_arg)
    norms = None
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        norms = pairwise.row_norms(dataset, squared=True)
    elif metric == DistanceType.CosineExpanded:
        norms = pairwise.row_norms(dataset, squared=False)
    q_scale = None
    if storage_dtype == torch.int8:
        if metric not in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                          DistanceType.InnerProduct, DistanceType.CosineExpanded):
            raise ValueError("int8 storage supports L2/IP/cosine metrics only")
        xf = dataset.float()
        q_scale = torch.clamp_min(xf.abs().max(), 1e-30) / 127.0
        # torch.round rounds half to even, as jnp.round does
        dataset = torch.clamp(torch.round(xf / q_scale), -127, 127).to(torch.int8)
    elif storage_dtype is not None:
        dataset = dataset.to(storage_dtype)
    return Index(dataset=dataset, norms=norms, q_scale=q_scale, metric=metric,
                 metric_arg=metric_arg)


def _tile_distances(metric, q, qn, tile, tile_norms, compute_dtype, scale2=None):
    """Distances between query chunk [B,d] and dataset tile [T,d] -> [B,T].

    ``scale2`` set => q and tile are int8; dots are exact int32, rescaled."""
    if callable(metric) and not isinstance(metric, DistanceType):
        return metric(q.float(), tile.float()).float()  # metric UDF
    if scale2 is None:
        dots = pairwise._gemm(q, tile, compute_dtype)
    else:
        dots = pairwise.int_dots(q, tile).float() * scale2
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        return torch.clamp_min(qn[:, None] + tile_norms[None, :] - 2.0 * dots, 0.0)
    if metric == DistanceType.InnerProduct:
        return dots
    if metric == DistanceType.CosineExpanded:
        return 1.0 - dots / torch.clamp_min(qn[:, None] * tile_norms[None, :], 1e-30)
    raise NotImplementedError(f"metric {metric!r} is not ported yet")


def _search_impl(dataset, norms, queries, prefilter, k, metric, tile_size, chunk,
                 compute_dtype, recall_target, q_scale=None):
    n = dataset.shape[0]
    nq = queries.shape[0]
    dev = dataset.device
    scale2 = None if q_scale is None else q_scale * q_scale
    is_udf = callable(metric) and not isinstance(metric, DistanceType)
    min_close = is_udf or metric != DistanceType.InnerProduct
    if norms is None:
        norms = torch.zeros((n,), dtype=torch.float32, device=dev)

    qf = queries.float()
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        qnorms = (qf * qf).sum(1)
    elif metric == DistanceType.CosineExpanded:
        qnorms = torch.sqrt((qf * qf).sum(1))
    else:
        qnorms = torch.zeros((nq,), dtype=torch.float32, device=dev)
    if q_scale is not None:  # quantize queries with the dataset's scale
        queries = torch.clamp(torch.round(qf / q_scale), -127, 127).to(torch.int8)
    kk = min(k, tile_size)
    out_v, out_i = [], []
    for c0 in range(0, nq, chunk):
        qc, qn = queries[c0:c0 + chunk], qnorms[c0:c0 + chunk]
        qid = torch.arange(c0, c0 + qc.shape[0], device=dev)
        best_v = best_i = None
        for t0 in range(0, n, tile_size):
            ids = torch.arange(t0, min(n, t0 + tile_size), device=dev)
            dist = _tile_distances(metric, qc, qn, dataset[t0:t0 + tile_size],
                                   norms[t0:t0 + tile_size], compute_dtype, scale2)
            order = dist if min_close else -dist
            mask = filt.passes(prefilter, qid[:, None], ids[None, :])
            if mask is not None:
                order = torch.where(mask, order, float("inf"))
            tv, tl = topk(order, kk, True, recall_target)
            ti = ids[tl].to(torch.int32)
            if n <= tile_size:  # one block: no merge
                best_v, best_i = tv, ti
                break
            if best_v is None:
                best_v = torch.full((qc.shape[0], k), float("inf"), device=dev)
                best_i = torch.zeros((qc.shape[0], k), dtype=torch.int32, device=dev)
            sv, sidx = topk(torch.cat([best_v, tv], 1), k, True)
            best_v, best_i = sv, torch.gather(torch.cat([best_i, ti], 1), 1, sidx)
        out_v.append(best_v)
        out_i.append(best_i)
    bv = torch.cat(out_v)
    bi = torch.cat(out_i)
    if bv.shape[1] < k:  # n < k: pad
        bv = torch.nn.functional.pad(bv, (0, k - bv.shape[1]), value=float("inf"))
        bi = torch.nn.functional.pad(bi, (0, k - bi.shape[1]))
    # postprocess (reference postprocess_distances semantics)
    if metric == DistanceType.L2SqrtExpanded:
        bv = torch.where(torch.isfinite(bv), torch.sqrt(torch.clamp_min(bv, 0.0)), bv)
    if not min_close:
        bv = -bv  # back to similarity, descending
    return bv, bi


@traced("brute_force::search")
def search(index: Index, queries, k: int, prefilter: Optional[filt.Prefilter] = None,
           tile_size: Optional[int] = None, query_chunk: int = 1024,
           compute_dtype=torch.float32, recall_target: Optional[float] = None,
           fused: bool = False, fused_tile_n: Optional[int] = None,
           fused_block_q: Optional[int] = None, fused_mxu_n: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN search. Returns (distances [nq,k], neighbors [nq,k] int32).

    ``fused=True`` routes unfiltered L2/IP searches through the fused
    distance + top-k kernels (ops/bf_topk.py): exact for k <= 64 without
    ``recall_target``, per-lane-bin approximate with it for k <= 128. On CPU
    tensors the fused route runs the kernels' plain PyTorch versions (the
    reference instead falls back to the unfused path off the TPU).
    ``recall_target`` alone changes nothing on the unfused path (selection is
    exact). Filtered-out / padded slots carry +inf (-inf for InnerProduct).
    ``tile_size`` defaults to the whole dataset when the [chunk, n] block fits
    in ~512 MB, else column tiles.
    """
    queries = torch.as_tensor(queries, device=index.device)
    nq = queries.shape[0]
    if prefilter is None:
        prefilter = filt.no_filter()
    exact_sel = recall_target is None
    if (fused and prefilter.is_none
            and index.metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                                 DistanceType.InnerProduct)
            # exact mode keeps k candidates per tile; approx mode needs k to
            # fit the per-tile bin pool
            and ((exact_sel and k <= 64) or (not exact_sel and k <= 128))):
        from cuvs_tpu_torch.ops import bf_topk

        return bf_topk.search(index.dataset, index.norms, queries, int(k), metric=index.metric,
                              compute_dtype=compute_dtype, exact=exact_sel,
                              q_scale=index.q_scale, tile_n=fused_tile_n,
                              block_q=fused_block_q, mxu_n=fused_mxu_n)
    query_chunk = int(min(query_chunk, max(8, nq)))
    if tile_size is None:
        budget_cols = max(8192, (512 * 1024 * 1024 // 4) // max(query_chunk, 1))
        tile_size = min(index.size, budget_cols)
    tile_size = int(min(tile_size, max(128, index.size)))
    return _search_impl(index.dataset, index.norms, queries, prefilter, int(k), index.metric,
                        tile_size, query_chunk, compute_dtype, recall_target, index.q_scale)
