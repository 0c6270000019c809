"""IVF-SQ: inverted file over int8 scalar-quantized rows — port of ``cuvs_tpu.neighbors.ivf_sq``.

Storage is 4x smaller than IVF-Flat's f32 (ivf_sq.hpp:36-77). One affine
dequantization serves every dim, y = a*c + b (trained at quantile 0.99), so
``q . y = a (q . c) + b * sum(q)``: the scan takes int8-code dots and applies
the affine epilogue, never building dequantized rows. The query-major scan
runs the queries in chunks that bound its [queries, W, d] window gather.
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
from cuvs_tpu_torch.preprocessing import quantize as pq
from cuvs_tpu_torch.utils.device import as_tensor as _on_device

# elements of one probe's f32 [queries, W, d] window block (256 MB)
_SCAN_BLOCK = 1 << 26


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Mirrors ivf_sq::index_params (ivf_sq.hpp:36-62)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    quantile: float = 0.99
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "metric", normalize_metric(self.metric))


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """``compute_dtype=torch.float32`` multiplies in IEEE fp32 (TF32 off)."""

    n_probes: int = 20
    compute_dtype: object = torch.float32
    recall_target: object = None


@dataclasses.dataclass
class Index:
    centers: torch.Tensor
    center_norms: torch.Tensor
    sorted_codes: torch.Tensor  # [n + W, d] int8
    sorted_norms: torch.Tensor  # [n + W] squared norms of the dequantized rows
    q_min: torch.Tensor  # 0-d f32, the quantizer's range
    q_max: torch.Tensor
    lists: ivf.SortedLists
    metric: DistanceType = DistanceType.L2Expanded
    window: int = 128
    n_rows: int = 0

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def size(self) -> int:
        return self.n_rows

    @property
    def device(self) -> torch.device:
        return self.centers.device


def build(dataset, params: Optional[IndexParams] = None, device=None, **kw) -> Index:
    """Train the coarse quantizer and the scalar quantizer, encode and sort
    the rows. Host data goes to ``device`` (None: the card)."""
    if params is None:
        params = IndexParams(**kw)
    xf = _on_device(dataset, device).float()
    n = xf.shape[0]
    n_lists = min(params.n_lists, n)
    centers = kmeans_balanced.fit(
        xf, n_lists,
        kmeans_balanced.BalancedParams(n_clusters=n_lists, n_iters=params.kmeans_n_iters,
                                       trainset_fraction=params.kmeans_trainset_fraction,
                                       seed=params.seed))
    labels = kmeans_balanced.predict(xf, centers)
    sq = pq.scalar_train(xf, quantile=params.quantile)
    codes = pq.scalar_transform(sq, xf)
    norms = pairwise.row_norms(pq.scalar_inverse_transform(sq, codes))
    window = ivf.round_window(int(torch.bincount(labels.long(), minlength=n_lists).max()))
    order, lists = ivf.sort_by_label(labels, n_lists, pad=window)
    sorted_codes = torch.cat([codes[order], codes.new_zeros((window, xf.shape[1]))])
    sorted_norms = torch.nn.functional.pad(norms[order], (0, window))
    return Index(centers=centers, center_norms=pairwise.row_norms(centers),
                 sorted_codes=sorted_codes, sorted_norms=sorted_norms, q_min=sq.min_,
                 q_max=sq.max_, lists=lists, metric=params.metric, window=window, n_rows=int(n))


def _search_impl(index: Index, queries, prefilter, k: int, n_probes: int, compute_dtype,
                 recall_target, qchunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-major scan per chunk of queries: probe by probe, int8-code dots
    with the affine epilogue and a running top-k merge."""
    metric = index.metric
    lists = index.lists
    window = index.window
    ip = metric == DistanceType.InnerProduct
    qf_all = queries.float()
    probe_all = ivf.coarse_search(qf_all, index.centers, index.center_norms, n_probes, metric)
    # dequant: y = a * (c + 128) + q_min  =>  y = a*c + (128a + q_min)
    a = torch.clamp_min(index.q_max - index.q_min, 1e-30) / torch.full_like(index.q_max, 255.0)
    b = 128.0 * a + index.q_min
    out_v, out_i = [], []
    for c0 in range(0, qf_all.shape[0], qchunk):
        qf = qf_all[c0:c0 + qchunk]
        qnorm = (qf * qf).sum(1)
        qsum = qf.sum(1)
        qc = qf.to(compute_dtype).float()

        def score(cluster, starts):
            codes_w = ivf.window_gather(index.sorted_codes, starts, window)  # [nq, W, d] int8
            norm_w = ivf.window_gather(index.sorted_norms, starts, window)
            raw = torch.bmm(codes_w.to(compute_dtype).float(), qc[:, :, None])[:, :, 0]
            dots = a * raw + b * qsum[:, None]  # q . dequant(c)
            return -dots if ip else torch.clamp_min(qnorm[:, None] + norm_w - 2.0 * dots, 0.0)

        best_v, best_i = ivf.query_major_topk(
            lists, probe_all[c0:c0 + qchunk], window, k, prefilter,
            torch.arange(c0, c0 + qf.shape[0], device=qf.device), score, recall_target)
        out_v.append(best_v)
        out_i.append(best_i)
    bv = torch.cat(out_v)
    if ip:
        bv = -bv
    return ivf.postprocess_distances(bv, metric), torch.cat(out_i)


def search(index: Index, queries, k: int, params: Optional[SearchParams] = None,
           prefilter: Optional[filt.Prefilter] = None, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search over the int8 codes. Returns (distances [nq, k], neighbors
    [nq, k] global ids int32); pair with neighbors.refine for exact ranking."""
    if params is None:
        params = SearchParams(**kw)
    if prefilter is None:
        prefilter = filt.no_filter()
    queries = torch.as_tensor(queries, device=index.device)
    d = index.sorted_codes.shape[1]
    qchunk = int(max(1, min(queries.shape[0], _SCAN_BLOCK // max(1, index.window * d))))
    return _search_impl(index, queries, prefilter, int(k), int(min(params.n_probes, index.n_lists)),
                        params.compute_dtype, params.recall_target, qchunk)
