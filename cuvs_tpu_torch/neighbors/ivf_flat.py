"""IVF-Flat: inverted-file index over raw vectors — port of ``cuvs_tpu.neighbors.ivf_flat``.

Build (ivf_flat_build.cuh:394): a balanced k-means coarse quantizer, then the
rows sorted by list into one dense array (``ivf_common``) with exact f32 norms
of the original rows; optional int8 (global scale) or bfloat16 storage; the
row width is padded to a multiple of 128 with zero columns, which change no
result and keep the reference's layout. Search (ivf_flat_search.cuh): coarse
probe selection, then either the fused cluster-major scan kernel
(``scan_algo="fused"``) or a query-major scan over probes with a running
top-k merge. Defaults mirror the reference: n_lists=1024,
kmeans_n_iters=20, kmeans_trainset_fraction=0.5, n_probes=20.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils.tracing import traced

_FUSED_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                  DistanceType.InnerProduct)


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Mirrors ivf_flat::index_params (ivf_flat.hpp:28-66)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    adaptive_centers: bool = False
    add_data_on_build: bool = True
    seed: int = 0
    # torch.int8 stores globally-scaled int8 rows (exact f32 norms kept);
    # torch.bfloat16 halves the bytes; None keeps the dataset dtype
    storage_dtype: object = None

    def __post_init__(self):
        object.__setattr__(self, "metric", normalize_metric(self.metric))


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Mirrors ivf_flat::search_params (ivf_flat.hpp:76).

    ``scan_algo``: "auto" | "query_major" | "fused". "fused" runs the fused
    scan kernel (L2/IP; other metrics fall back to query_major). "auto" picks
    fused for large batches (nq * n_probes >= 4 * n_lists) of L2/IP queries
    on a CUDA device, query_major otherwise. ``recall_target`` is accepted
    for parity; selection is exact. ``metric_udf``: a search-time metric
    ``fn(x [m,d], y [n,d]) -> [m,n]`` (min = close), query_major only."""

    n_probes: int = 20
    compute_dtype: object = torch.float32
    recall_target: object = None
    scan_algo: str = "auto"
    metric_udf: object = None


@dataclasses.dataclass
class Index:
    centers: torch.Tensor  # [n_lists, d]
    center_norms: torch.Tensor  # [n_lists] (squared L2, or L2 for cosine)
    sorted_data: torch.Tensor  # [n + W, dp] rows grouped by list
    sorted_norms: torch.Tensor  # [>= n + W] squared norms of the original rows
    lists: ivf.SortedLists
    q_scale: Optional[torch.Tensor] = None  # 0-d f32, int8 storage only
    metric: DistanceType = DistanceType.L2Expanded
    window: int = 128
    n_rows: int = 0
    adaptive_centers: bool = False

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def size(self) -> int:
        return self.n_rows

    @property
    def device(self) -> torch.device:
        return self.sorted_data.device


def _center_norms(centers, metric):
    return pairwise.row_norms(centers, squared=metric != DistanceType.CosineExpanded)


def _norm_pad_len(n: int, window: int) -> int:
    """Length of sorted_norms: the reference's padded length, so an index
    carried across between the packages keeps its layout."""
    n_pad_rows = n + window
    wn = -(-(window + 1024) // 1024) * 1024
    return (n_pad_rows // 1024 + 1) * 1024 + wn


def _gather_rows(ds: torch.Tensor, order: torch.Tensor, out_dtype, chunk: int = 1 << 20):
    """ds[order] in out_dtype, converted chunk by chunk so no full-size f32
    transient exists next to the source."""
    out = torch.empty((order.shape[0], ds.shape[1]), dtype=out_dtype, device=ds.device)
    for r0 in range(0, order.shape[0], chunk):
        out[r0:r0 + chunk] = ds[order[r0:r0 + chunk]].to(out_dtype)
    return out


def _pack(dataset, ids, labels, centers, metric, n_lists, adaptive, storage_dtype=None,
          q_scale=None, norms=None) -> Index:
    """Assemble the index from labeled rows."""
    dev = dataset.device
    if dataset.shape[0] == 0:
        # empty index (add_data_on_build=False): quantizer only
        window = ivf.round_window(0)
        _, lists = ivf.sort_by_label(torch.zeros((0,), dtype=torch.int32, device=dev), n_lists,
                                     pad=window)
        dt = storage_dtype if storage_dtype is not None else dataset.dtype
        dp = -(-dataset.shape[1] // 128) * 128
        return Index(centers=centers, center_norms=_center_norms(centers, metric),
                     sorted_data=torch.zeros((window, dp), dtype=dt, device=dev),
                     sorted_norms=torch.zeros((_norm_pad_len(0, window),), device=dev),
                     lists=lists, q_scale=None, metric=metric, window=window, n_rows=0,
                     adaptive_centers=adaptive)
    sizes_max = int(torch.bincount(labels.long(), minlength=n_lists).max())
    window = ivf.round_window(sizes_max)
    order, lists = ivf.sort_by_label(labels, n_lists, pad=window)
    global_ids = torch.cat([ids.to(torch.int32)[order],
                            torch.zeros((window,), dtype=torch.int32, device=dev)])
    lists = lists._replace(ids=global_ids)
    if norms is None:  # always from the original rows
        norms = pairwise.row_norms(dataset)
    if storage_dtype == torch.int8 and dataset.dtype != torch.int8:
        # quantize before reordering: the gather moves int8 rows
        if q_scale is None:
            q_scale = torch.clamp_min(dataset.float().abs().max(), 1e-30) / 127.0
        x8 = torch.clamp(torch.round(dataset.float() / q_scale), -127, 127).to(torch.int8)
        rows = x8[order]
    else:
        rows = _gather_rows(dataset, order,
                            storage_dtype if storage_dtype is not None else dataset.dtype)
    dp = -(-rows.shape[1] // 128) * 128
    sorted_data = torch.zeros((rows.shape[0] + window, dp), dtype=rows.dtype, device=dev)
    sorted_data[:rows.shape[0], :rows.shape[1]] = rows
    n = dataset.shape[0]
    sorted_norms = torch.zeros((_norm_pad_len(n, window),), dtype=torch.float32, device=dev)
    sorted_norms[:n] = norms[order]
    return Index(centers=centers, center_norms=_center_norms(centers, metric),
                 sorted_data=sorted_data, sorted_norms=sorted_norms, lists=lists,
                 q_scale=q_scale, metric=metric, window=window, n_rows=n,
                 adaptive_centers=adaptive)


@traced("ivf_flat::build")
def build(dataset, params: Optional[IndexParams] = None, device=None, **kw) -> Index:
    """Train the coarse quantizer and populate the lists (ivf_flat_build.cuh:394)."""
    if params is None:
        params = IndexParams(**kw)
    dataset = torch.as_tensor(dataset, device=device)
    n = dataset.shape[0]
    n_lists = min(params.n_lists, n)
    trainset = dataset.float()
    centers = kmeans_balanced.fit(
        trainset, n_lists,
        kmeans_balanced.BalancedParams(n_clusters=n_lists, n_iters=params.kmeans_n_iters,
                                       trainset_fraction=params.kmeans_trainset_fraction,
                                       seed=params.seed))
    if params.metric == DistanceType.CosineExpanded:
        # cosine lists are built on normalized geometry
        centers = centers / torch.clamp_min(torch.linalg.norm(centers, dim=1, keepdim=True), 1e-30)
        normed = trainset / torch.clamp_min(torch.linalg.norm(trainset, dim=1, keepdim=True),
                                            1e-30)
        labels = kmeans_balanced.predict(normed, centers)
    else:
        labels = kmeans_balanced.predict(trainset, centers)
    del trainset
    ids = torch.arange(n, dtype=torch.int32, device=dataset.device)
    if not params.add_data_on_build:
        dataset, ids, labels = dataset[:0], ids[:0], labels[:0]
    return _pack(dataset, ids, labels, centers, params.metric, n_lists,
                 params.adaptive_centers, params.storage_dtype)


def _search_impl(index: Index, queries, prefilter, k, n_probes, metric, compute_dtype,
                 recall_target):
    """Query-major scan: probe by probe, a running top-k merge."""
    nq, d = queries.shape
    dev = queries.device
    lists = index.lists
    window = index.window
    qf = queries.float()
    probe_ids = ivf.coarse_search(qf, index.centers, index.center_norms, n_probes, metric,
                                  compute_dtype)
    is_udf = callable(metric) and not isinstance(metric, DistanceType)
    if is_udf or metric == DistanceType.InnerProduct:
        qnorm = torch.zeros((nq,), device=dev)
    elif metric == DistanceType.CosineExpanded:
        qnorm = torch.sqrt((qf * qf).sum(1))
    else:
        qnorm = (qf * qf).sum(1)
    qid = torch.arange(nq, device=dev)
    dp = index.sorted_data.shape[1]
    qp_f = torch.nn.functional.pad(qf, (0, dp - d)) if dp != d else qf
    if index.q_scale is not None:  # int8 storage: quantized queries, int32 dots
        qc = torch.clamp(torch.round(qp_f / index.q_scale), -127, 127).to(torch.int8)
        scale2 = index.q_scale * index.q_scale
    else:
        qc = qp_f.to(compute_dtype).float()
        scale2 = None

    best_v = torch.full((nq, k), float("inf"), device=dev)
    best_i = torch.zeros((nq, k), dtype=torch.int32, device=dev)
    for j in range(n_probes):
        cluster = probe_ids[:, j].long()
        starts = lists.offsets[cluster]
        data_w = ivf.window_gather(index.sorted_data, starts, window)  # [nq, W, dp]
        ids_w = ivf.window_gather(lists.ids, starts, window)
        lab_w = ivf.window_gather(lists.labels, starts, window)
        norm_w = ivf.window_gather(index.sorted_norms, starts, window)
        if is_udf:
            data_f = data_w[..., :d].float()
            if index.q_scale is not None:
                data_f = data_f * index.q_scale
            order = torch.stack([metric(qf[i:i + 1], data_f[i])[0] for i in range(nq)]).float()
        else:
            if scale2 is not None:
                dots = torch.bmm(data_w.float(), qc.float()[:, :, None])[:, :, 0] * scale2
            else:
                dots = torch.bmm(data_w.to(compute_dtype).float(), qc[:, :, None])[:, :, 0]
            if metric == DistanceType.InnerProduct:
                order = -dots
            elif metric == DistanceType.CosineExpanded:
                order = 1.0 - dots / torch.clamp_min(qnorm[:, None] * torch.sqrt(norm_w), 1e-30)
            else:
                order = torch.clamp_min(qnorm[:, None] + norm_w - 2.0 * dots, 0.0)
        valid = lab_w == cluster[:, None]
        mask = filt.passes(prefilter, qid[:, None], ids_w)
        if mask is not None:
            valid = valid & mask
        order = torch.where(valid, order, float("inf"))
        tv, tl = topk(order, min(k, window), True, recall_target)
        ti = torch.gather(ids_w, 1, tl)
        sv, sidx = topk(torch.cat([best_v, tv], 1), k, True)
        best_v, best_i = sv, torch.gather(torch.cat([best_i, ti], 1), 1, sidx)
    if metric == DistanceType.InnerProduct:
        best_v = -best_v
    return ivf.postprocess_distances(best_v, metric), best_i


@traced("ivf_flat::search")
def search(index: Index, queries, k: int, params: Optional[SearchParams] = None,
           prefilter: Optional[filt.Prefilter] = None, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search. Returns (distances [nq,k], neighbors [nq,k] global ids int32)."""
    if params is None:
        params = SearchParams(**kw)
    if prefilter is None:
        prefilter = filt.no_filter()
    queries = torch.as_tensor(queries, device=index.device)
    n_probes = min(params.n_probes, index.n_lists)
    nq = queries.shape[0]
    algo = params.scan_algo
    metric = index.metric
    if algo not in ("auto", "query_major", "fused"):
        raise ValueError(f"scan_algo {algo!r}: the port has auto, query_major and fused")
    if params.metric_udf is not None:
        metric = params.metric_udf
        algo = "query_major"
    if algo == "auto":
        big = nq * n_probes >= 4 * index.n_lists
        algo = "fused" if big and queries.is_cuda and metric in _FUSED_METRICS else "query_major"
    if algo == "fused" and metric not in _FUSED_METRICS:
        algo = "query_major"
    if algo == "fused":
        from cuvs_tpu_torch.neighbors import ivf_scan

        qf = queries.float()
        probe_ids = ivf.coarse_search(qf, index.centers, index.center_norms, n_probes, metric,
                                      params.compute_dtype)
        M = int(min(128, max(8, nq)))
        n_tiles = nq * n_probes // M + min(index.n_lists, nq * n_probes) + 1
        return ivf_scan.cluster_major_scan_fused(
            index.sorted_data, index.sorted_norms, index.lists, qf, probe_ids, int(k), metric,
            index.window, M, params.compute_dtype, int(n_tiles), params.recall_target,
            index.q_scale, prefilter=prefilter)
    return _search_impl(index, queries, prefilter, int(k), int(n_probes), metric,
                        params.compute_dtype, params.recall_target)
