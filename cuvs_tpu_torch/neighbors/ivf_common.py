"""Shared IVF machinery — port of ``cuvs_tpu.neighbors.ivf_common``.

List storage is the reference's: dataset rows sorted by list label into one
dense array with per-list offsets and sizes; a probe reads the static-width
window ``sorted[offsets[c] : offsets[c] + window]`` and masks rows whose label
is not c.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.selection.select_k import select_k, topk
from cuvs_tpu_torch.utils.tracing import traced

# elements of a metric UDF's broadcast [queries, lists, d] block in the coarse
# search (256 MB of f32)
_UDF_BLOCK = 1 << 26


class SortedLists(NamedTuple):
    """Dense sorted list storage."""

    offsets: torch.Tensor  # [n_lists] int32 start of each list
    sizes: torch.Tensor  # [n_lists] int32
    labels: torch.Tensor  # [n + W] int32 list id per sorted row (-1 pad)
    ids: torch.Tensor  # [n + W] int32 global row id (0 pad)


def sort_by_label(labels: torch.Tensor, n_lists: int, pad: int):
    """Group rows by label (stable). Returns (order [n] int64, SortedLists
    with ``pad`` extra rows)."""
    labels = labels.to(torch.int64)
    order = torch.argsort(labels, stable=True)
    sorted_labels = labels[order]
    sizes = torch.bincount(labels, minlength=n_lists).to(torch.int32)
    offsets = (torch.cumsum(sizes, 0) - sizes).to(torch.int32)
    dev = labels.device
    lab_p = torch.cat([sorted_labels.to(torch.int32),
                       torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    ids_p = torch.cat([order.to(torch.int32), torch.zeros((pad,), dtype=torch.int32, device=dev)])
    return order, SortedLists(offsets=offsets, sizes=sizes, labels=lab_p, ids=ids_p)


def round_window(max_size: int, multiple: int = 128) -> int:
    return max(multiple, -(-int(max_size) // multiple) * multiple)


@traced("ivf::coarse_search")
def coarse_search(queries_f32: torch.Tensor, centers: torch.Tensor, center_norms: torch.Tensor,
                  n_probes: int, metric, compute_dtype=torch.float32) -> torch.Tensor:
    """Top-n_probes closest lists per query -> [nq, n_probes] int32
    (GEMM + select_k, ivf_flat_search.cuh:148-187)."""
    if callable(metric) and not isinstance(metric, DistanceType):
        # in query chunks: a broadcast UDF builds [chunk, n_lists, d]
        nq, d = queries_f32.shape
        step = max(1, _UDF_BLOCK // max(1, centers.shape[0] * d))
        score = torch.cat([metric(queries_f32[s:s + step], centers).float()
                           for s in range(0, nq, step)])
        return select_k(score, n_probes, select_min=True)[1]
    dots = pairwise._gemm(queries_f32, centers, compute_dtype)
    if metric == DistanceType.InnerProduct:
        score, select_min = dots, False
    elif metric == DistanceType.CosineExpanded:
        score, select_min = dots / torch.clamp_min(center_norms[None, :], 1e-30), False
    else:  # L2 family: |c|^2 - 2 q.c ranks like the full L2
        score, select_min = center_norms[None, :] - 2.0 * dots, True
    return select_k(score, n_probes, select_min=select_min)[1]


def window_gather(sorted_arr: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """Rows [start_i : start_i + window] per i -> [b, window, ...]. Starts are
    clamped so the window stays inside the array, as lax.dynamic_slice does."""
    starts = torch.clamp(starts.to(torch.int64), 0, sorted_arr.shape[0] - window)
    idx = starts[:, None] + torch.arange(window, device=sorted_arr.device)[None, :]
    return sorted_arr[idx]


@traced("ivf::query_major")
def query_major_topk(lists: SortedLists, probes: torch.Tensor, window: int, k: int, prefilter,
                     qid: torch.Tensor, score: Callable, recall_target=None):
    """The query-major probe loop shared by the IVF scans: per probe column,
    ``score(cluster [nq], starts [nq]) -> order [nq, window]`` (min = close)
    over each query's window; rows outside the probed list or dropped by the
    prefilter (queries ``qid``) go to +inf; each probe's top-k merges into a
    running top-k. Returns (order values [nq, k], global ids [nq, k] int32)."""
    nq = probes.shape[0]
    best_v = torch.full((nq, k), float("inf"), device=probes.device)
    best_i = torch.zeros((nq, k), dtype=torch.int32, device=probes.device)
    for j in range(probes.shape[1]):
        cluster = probes[:, j].long()
        starts = lists.offsets[cluster]
        ids_w = window_gather(lists.ids, starts, window)
        valid = window_gather(lists.labels, starts, window) == cluster[:, None]
        mask = filt.passes(prefilter, qid[:, None], ids_w)
        if mask is not None:
            valid = valid & mask
        order = torch.where(valid, score(cluster, starts), float("inf"))
        tv, tl = topk(order, min(k, window), True, recall_target)
        best_v, sidx = topk(torch.cat([best_v, tv], 1), k, True)
        best_i = torch.gather(torch.cat([best_i, torch.gather(ids_w, 1, tl)], 1), 1, sidx)
    return best_v, best_i


def postprocess_distances(dists: torch.Tensor, metric) -> torch.Tensor:
    """Final metric transform (ivf_common.cuh:176 postprocess_distances)."""
    if metric == DistanceType.L2SqrtExpanded:
        return torch.where(torch.isfinite(dists), torch.sqrt(torch.clamp_min(dists, 0.0)), dists)
    return dists
