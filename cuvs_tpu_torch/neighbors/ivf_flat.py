"""IVF-Flat: inverted-file index over raw vectors — port of ``cuvs_tpu.neighbors.ivf_flat``.

Build (ivf_flat_build.cuh:394): a balanced k-means coarse quantizer, then the
rows sorted by list into one dense array (``ivf_common``) with exact f32 norms
of the original rows; optional int8 (global scale) or bfloat16 storage; the
row width is padded to a multiple of 128 with zero columns, which change no
result and keep the reference's layout. ``extend`` appends rows to their
nearest lists; ``build_streaming`` builds an int8 index from slices of a
source too large for the card. Search (ivf_flat_search.cuh): coarse probe
selection, then the fused cluster-major scan kernel (``scan_algo="fused"``),
the unfused cluster-major scan over pair tiles (``"cluster_major"``: cosine,
metric UDFs) or a query-major scan over probes with a running top-k merge.
Defaults mirror the reference: n_lists=1024, kmeans_n_iters=20,
kmeans_trainset_fraction=0.5, n_probes=20.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.neighbors import ivf_scan
from cuvs_tpu_torch.utils import tracing
from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.device import resolve_device

# elements of the unfused cluster-major scan's [C, M, W] block (256 MB of f32)
_CM_BUDGET = 256 * 1024 * 1024 // 4


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

    ``scan_algo``: "auto" | "query_major" | "cluster_major" | "fused", as
    ``ivf_scan.scan_path`` resolves it with cluster_major as the fallback:
    "fused" runs the fused scan kernel (L2/IP); "auto" picks it for large
    batches on a CUDA device. ``recall_target`` is accepted for parity;
    selection is exact. ``metric_udf``: a search-time metric
    ``fn(x [m,d], y [n,d]) -> [m,n]`` (min = close), scanned by
    cluster_major for large batches and query_major otherwise."""

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


def _quantize(x: torch.Tensor, q_scale: torch.Tensor) -> torch.Tensor:
    """int8 rows round(x / q_scale) (an IEEE division by a tensor)."""
    return torch.clamp(torch.round(x / q_scale), -127, 127).to(torch.int8)


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
        rows = _quantize(dataset.float(), q_scale)[order]
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


@tracing.traced("ivf_flat::build")
def build(dataset, params: Optional[IndexParams] = None, device=None, **kw) -> Index:
    """Train the coarse quantizer and populate the lists (ivf_flat_build.cuh:394)."""
    if params is None:
        params = IndexParams(**kw)
    dataset = _on_device(dataset, device)
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


def extend(index: Index, new_vectors, new_ids=None) -> Index:
    """Append vectors to their nearest lists (ivf_flat extend semantics).

    An int8 index quantizes the new rows with its scale; an empty one
    (``add_data_on_build=False``) calibrates the scale from the first rows it
    receives. Rows are labeled from their float values: the reference labels
    an int8 index's new rows from their codes against the float centers,
    which sends some of them to another list. ``adaptive_centers`` moves each
    center to the mean of its list (deterministic segment sums)."""
    new_vectors = _on_device(new_vectors, index.device)
    nf = new_vectors.float()
    new_norms = pairwise.row_norms(nf)
    q_scale = index.q_scale
    if (q_scale is None and index.n_rows == 0 and index.sorted_data.dtype == torch.int8
            and new_vectors.dtype != torch.int8):
        q_scale = torch.clamp_min(nf.abs().max(), 1e-30) / 127.0
    new_labels = kmeans_balanced.predict(nf, index.centers)
    if q_scale is not None:
        new_vectors = _quantize(nf, q_scale)
    new_vectors = new_vectors.to(index.sorted_data.dtype)
    n_old = index.n_rows
    n_new = new_vectors.shape[0]
    if new_ids is None:
        new_ids = torch.arange(n_old, n_old + n_new, dtype=torch.int32, device=index.device)
    all_data = torch.cat([index.sorted_data[:n_old, :index.dim], new_vectors])
    all_ids = torch.cat([index.lists.ids[:n_old],
                         torch.as_tensor(new_ids, device=index.device).to(torch.int32)])
    all_labels = torch.cat([index.lists.labels[:n_old], new_labels.to(torch.int32)])
    centers = index.centers
    if index.adaptive_centers:
        all_f32 = all_data.float()
        if q_scale is not None:  # dequantized for the center math
            all_f32 = all_f32 * q_scale
        centers, _ = kmeans_balanced._segment_mean(all_f32, all_labels, index.n_lists, centers)
    all_norms = torch.cat([index.sorted_norms[:n_old], new_norms])
    return _pack(all_data, all_ids, all_labels, centers, index.metric, index.n_lists,
                 index.adaptive_centers, q_scale=q_scale, norms=all_norms)


def _slice_positions(labels_all, offsets, cursor, row0: int, rows: int, n_lists: int):
    """Final positions of one slice's rows: each list's rows follow its
    earlier slices' rows in source order. Advances ``cursor`` (rows placed
    per list so far)."""
    lab = labels_all[row0:row0 + rows]
    order = np.argsort(lab, kind="stable")
    so = lab[order]
    starts = np.concatenate([[0], np.flatnonzero(so[1:] != so[:-1]) + 1])
    grp = np.repeat(np.arange(len(starts)), np.diff(np.concatenate([starts, [rows]])))
    rank = np.empty(rows, np.int64)
    rank[order] = np.arange(rows) - starts[grp]
    pos = offsets[lab] + cursor[lab] + rank
    cursor += np.bincount(lab, minlength=n_lists)
    return lab, pos


def build_streaming(slice_provider, n_slices: int, n_lists: int = 16384,
                    metric: DistanceType = DistanceType.L2Expanded, trainset_rows: int = 2_000_000,
                    kmeans_n_iters: int = 10, seed: int = 0, align_dim: bool = True,
                    device=None) -> Index:
    """IVF-Flat build with int8 list storage from a source too large for the
    card: the card holds the final index plus one slice.

    ``slice_provider(i) -> [rows, d]`` float rows, called up to 3 times per
    slice (re-read or regenerate, don't cache). Two modes, by what it returns:

    * tensors (device mode): labels, norms and the scale are computed where
      the slices live; rows are quantized there and written into tensors
      allocated at their final size (``index_copy_``).
    * numpy arrays (host mode, the index on ``device``; None: the card):
      each slice is uploaded as f32 and cast to bf16 on the card for
      labeling, as the reference does; rows are quantized and placed in
      numpy f32 (the reference's int8 rows bit for bit), then each final
      array crosses once.

    ``align_dim`` pads the row width to a multiple of 128 in both modes."""
    metric = normalize_metric(metric)
    if metric not in ivf_scan.FUSED_METRICS:
        raise ValueError("build_streaming supports L2/IP metrics")
    first = slice_provider(0)
    device_mode = isinstance(first, torch.Tensor)
    dev = (first.device if device is None else torch.device(device)) if device_mode \
        else resolve_device(device)
    d = int(first.shape[1])
    del first
    dp = -(-d // 128) * 128 if align_dim else d

    # pass 0: a strided subsample trains the quantizer
    sub = []
    for i in range(n_slices):
        sl = slice_provider(i)
        sl = sl.to(dev).float() if device_mode else np.asarray(sl, np.float32)
        sub.append(sl[::max(1, sl.shape[0] * n_slices // trainset_rows)])
    trainset = (torch.cat(sub) if device_mode
                else torch.from_numpy(np.concatenate(sub)).to(dev))[:trainset_rows]
    del sub
    centers = kmeans_balanced.fit(
        trainset, n_lists,
        kmeans_balanced.BalancedParams(n_clusters=n_lists, n_iters=kmeans_n_iters,
                                       trainset_fraction=1.0, seed=seed))
    del trainset

    # pass 1: labels, norms and the scale
    labels_h, norms_h = [], []
    amax = 0.0
    for i in range(n_slices):
        if device_mode:
            sl = slice_provider(i).to(dev).float()
            labels_h.append(kmeans_balanced.predict(sl, centers).cpu().numpy())
            norms_h.append(pairwise.row_norms(sl).cpu().numpy())
            amax = max(amax, float(sl.abs().max()))
        else:
            sl = np.asarray(slice_provider(i), np.float32)
            up = torch.from_numpy(sl).to(dev).to(torch.bfloat16)
            labels_h.append(kmeans_balanced.predict(up, centers).cpu().numpy())
            norms_h.append(np.einsum("ij,ij->i", sl, sl, dtype=np.float32))
            amax = max(amax, float(np.max(np.abs(sl))))
    labels_all = np.concatenate(labels_h).astype(np.int64)
    n = labels_all.shape[0]
    q_scale = max(amax, 1e-30) / 127.0
    sizes = np.bincount(labels_all, minlength=n_lists).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    window = ivf.round_window(int(sizes.max()))

    # pass 2: quantize and place each slice's rows
    cursor = np.zeros(n_lists, np.int64)
    row0 = 0
    if device_mode:
        scale_t = torch.tensor(q_scale, dtype=torch.float32, device=dev)
        data = torch.zeros((n + window, dp), dtype=torch.int8, device=dev)
        norms_a = torch.zeros((_norm_pad_len(n, window),), dtype=torch.float32, device=dev)
        labels_a = torch.full((n + window,), -1, dtype=torch.int32, device=dev)
        ids_a = torch.zeros((n + window,), dtype=torch.int32, device=dev)
        for i in range(n_slices):
            sl = slice_provider(i).to(dev).float()
            rows = sl.shape[0]
            lab, pos = _slice_positions(labels_all, offsets, cursor, row0, rows, n_lists)
            posd = torch.from_numpy(pos).to(dev)
            q8 = torch.nn.functional.pad(_quantize(sl, scale_t), (0, dp - d))
            data.index_copy_(0, posd, q8)
            norms_a.index_copy_(0, posd, torch.from_numpy(norms_h[i]).to(dev))
            labels_a.index_copy_(0, posd, torch.from_numpy(lab.astype(np.int32)).to(dev))
            ids_a.index_copy_(0, posd, torch.arange(row0, row0 + rows, dtype=torch.int32,
                                                    device=dev))
            row0 += rows
    else:
        data_h = np.zeros((n + window, dp), np.int8)
        norms_h2 = np.zeros((_norm_pad_len(n, window),), np.float32)
        labels_ah = np.full((n + window,), -1, np.int32)
        ids_ah = np.zeros((n + window,), np.int32)
        for i in range(n_slices):
            sl = np.asarray(slice_provider(i), np.float32)
            rows = sl.shape[0]
            lab, pos = _slice_positions(labels_all, offsets, cursor, row0, rows, n_lists)
            data_h[pos, :d] = np.clip(np.round(sl / q_scale), -127, 127).astype(np.int8)
            norms_h2[pos] = norms_h[i]
            labels_ah[pos] = lab
            ids_ah[pos] = np.arange(row0, row0 + rows, dtype=np.int32)
            row0 += rows
        data, norms_a = torch.from_numpy(data_h).to(dev), torch.from_numpy(norms_h2).to(dev)
        labels_a, ids_a = torch.from_numpy(labels_ah).to(dev), torch.from_numpy(ids_ah).to(dev)
    lists = ivf.SortedLists(offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
                            sizes=torch.from_numpy(sizes).to(dev), labels=labels_a, ids=ids_a)
    return Index(centers=centers, center_norms=_center_norms(centers, metric), sorted_data=data,
                 sorted_norms=norms_a, lists=lists,
                 q_scale=torch.tensor(q_scale, dtype=torch.float32, device=dev), metric=metric,
                 window=window, n_rows=n, adaptive_centers=False)


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
    dp = index.sorted_data.shape[1]
    qp_f = torch.nn.functional.pad(qf, (0, dp - d)) if dp != d else qf
    if index.q_scale is not None:  # int8 storage: quantized queries, int32 dots
        qc = torch.clamp(torch.round(qp_f / index.q_scale), -127, 127).to(torch.int8)
        scale2 = index.q_scale * index.q_scale
    else:
        qc = qp_f.to(compute_dtype).float()
        scale2 = None

    def score(cluster, starts):
        data_w = ivf.window_gather(index.sorted_data, starts, window)  # [nq, W, dp]
        if is_udf:
            data_f = data_w[..., :d].float()
            if index.q_scale is not None:
                data_f = data_f * index.q_scale
            # per-query fn(q [1, d], rows [W, d]) -> [1, W], vmapped over the batch
            return torch.func.vmap(lambda qq, yy: metric(qq[None, :], yy)[0])(qf, data_f).float()
        norm_w = ivf.window_gather(index.sorted_norms, starts, window)
        if scale2 is not None:
            dots = torch.bmm(data_w.float(), qc.float()[:, :, None])[:, :, 0] * scale2
        else:
            dots = torch.bmm(data_w.to(compute_dtype).float(), qc[:, :, None])[:, :, 0]
        if metric == DistanceType.InnerProduct:
            return -dots
        if metric == DistanceType.CosineExpanded:
            return 1.0 - dots / torch.clamp_min(qnorm[:, None] * torch.sqrt(norm_w), 1e-30)
        return torch.clamp_min(qnorm[:, None] + norm_w - 2.0 * dots, 0.0)

    best_v, best_i = ivf.query_major_topk(lists, probe_ids, window, k, prefilter,
                                          torch.arange(nq, device=dev), score, recall_target)
    if metric == DistanceType.InnerProduct:
        best_v = -best_v
    return ivf.postprocess_distances(best_v, metric), best_i


@tracing.traced("ivf_flat::search")
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
    tracing.count("queries", nq)
    algo, metric = params.scan_algo, index.metric
    fused_ok = metric in ivf_scan.FUSED_METRICS
    if params.metric_udf is not None:
        # the fused kernel has L2/IP epilogues only: a UDF search is routed by
        # its batch size alone
        metric, fused_ok = params.metric_udf, False
        if algo == "fused":
            algo = "auto"
    algo = ivf_scan.scan_path(algo, nq, n_probes, index.n_lists, fused_ok, queries.is_cuda,
                              "cluster_major")
    if algo == "query_major":
        return _search_impl(index, queries, prefilter, int(k), int(n_probes), metric,
                            params.compute_dtype, params.recall_target)
    qf = queries.float()
    probe_ids = ivf.coarse_search(qf, index.centers, index.center_norms, n_probes, metric,
                                  params.compute_dtype)
    M, n_tiles = ivf_scan.tile_geometry(nq, n_probes, index.n_lists)
    if algo == "fused":
        return ivf_scan.cluster_major_scan_fused(
            index.sorted_data, index.sorted_norms, index.lists, qf, probe_ids, int(k), metric,
            index.window, M, params.compute_dtype, n_tiles, params.recall_target,
            index.q_scale, prefilter=prefilter)
    # tiles per chunk: the [C, M, W] order tensor stays within 256 MB of f32,
    # and so does a broadcast metric UDF's [C, M, W, d] block
    per_tile = M * index.window * (index.dim if params.metric_udf is not None else 1)
    chunk = max(1, min(n_tiles, _CM_BUDGET // max(per_tile, 1)))
    return ivf_scan.cluster_major_scan_tiled(
        index.sorted_data, index.sorted_norms, index.lists, qf, probe_ids, prefilter, int(k),
        metric, index.window, M, int(chunk), params.compute_dtype, params.recall_target,
        n_tiles, index.q_scale)
