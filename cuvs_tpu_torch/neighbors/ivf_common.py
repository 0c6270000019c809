"""Shared IVF machinery — port of ``cuvs_tpu.neighbors.ivf_common``.

List storage is the reference's: dataset rows sorted by list label into one
dense array with per-list offsets and sizes; a probe reads the static-width
window ``sorted[offsets[c] : offsets[c] + window]`` and masks rows whose label
is not c.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType
from cuvs_tpu_torch.selection.select_k import select_k


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


def coarse_search(queries_f32: torch.Tensor, centers: torch.Tensor, center_norms: torch.Tensor,
                  n_probes: int, metric, compute_dtype=torch.float32) -> torch.Tensor:
    """Top-n_probes closest lists per query -> [nq, n_probes] int32
    (GEMM + select_k, ivf_flat_search.cuh:148-187)."""
    if callable(metric) and not isinstance(metric, DistanceType):
        score = metric(queries_f32, centers).float()
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


def postprocess_distances(dists: torch.Tensor, metric) -> torch.Tensor:
    """Final metric transform (ivf_common.cuh:176 postprocess_distances)."""
    if metric == DistanceType.L2SqrtExpanded:
        return torch.where(torch.isfinite(dists), torch.sqrt(torch.clamp_min(dists, 0.0)), dists)
    return dists
