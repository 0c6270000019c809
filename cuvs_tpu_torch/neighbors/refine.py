"""Exact re-ranking of candidate lists — port of ``cuvs_tpu.neighbors.refine``.

A candidate list is a gather: the [nq, c, d] candidate rows are dotted with
their query, scored by the exact metric, and the best k kept (refine.hpp:62).
An invalid (negative) candidate slot scores +inf and, as in the reference,
reports id 0. ``refine_host`` re-ranks against a dataset that stays on the
host: only the candidate rows cross to the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.tracing import traced


def _refine_impl(dataset, queries, candidates, k, metric, compute_dtype, qchunk):
    n = dataset.shape[0]
    out_v, out_i = [], []
    for c0 in range(0, queries.shape[0], qchunk):
        cand = torch.clamp_max(candidates[c0:c0 + qchunk], n - 1)  # ids past n read row n - 1
        vecs = dataset[torch.clamp_min(cand.long(), 0)]  # [B, c, d]
        v, i = _refine_rows_impl(vecs, queries[c0:c0 + qchunk], cand, k, metric, compute_dtype)
        out_v.append(v)
        out_i.append(i.to(candidates.dtype))
    return torch.cat(out_v), torch.cat(out_i)


@traced("refine::refine")
def refine(dataset, queries, candidates, k: int, metric="sqeuclidean",
           compute_dtype=torch.float32, query_chunk: int = 2048, device=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank ``candidates`` [nq, c] (global ids; negative = invalid) by the
    exact metric; returns the best k (distances [nq, k], ids [nq, k]). Host
    data goes to ``device`` (None: the CUDA card); queries and candidates
    follow the dataset."""
    metric = normalize_metric(metric)
    dataset = _on_device(dataset, device)
    queries = torch.as_tensor(queries, device=dataset.device)
    candidates = torch.as_tensor(candidates, device=dataset.device)
    if k > candidates.shape[1]:
        raise ValueError(f"k={k} > candidate count {candidates.shape[1]}")
    qchunk = int(min(query_chunk, max(8, queries.shape[0])))
    return _refine_impl(dataset, queries, candidates, int(k), metric, compute_dtype, qchunk)


def _refine_rows_impl(cand_vecs, queries, candidates, k, metric, compute_dtype):
    """Exact re-rank of gathered candidate rows cand_vecs [nq, c, d] (f32)."""
    ip = metric == DistanceType.InnerProduct
    q = queries.float()
    vecs = cand_vecs.float()
    qc = q.to(compute_dtype).float()
    dots = torch.bmm(vecs.to(compute_dtype).float(), qc[:, :, None])[:, :, 0]
    if ip:
        order = -dots
    elif metric == DistanceType.CosineExpanded:
        qn = torch.sqrt((q * q).sum(1))[:, None]
        vn = torch.sqrt((vecs * vecs).sum(2))
        order = 1.0 - dots / torch.clamp_min(qn * vn, 1e-30)
    else:
        qn = (q * q).sum(1)[:, None]
        vn = (vecs * vecs).sum(2)
        order = torch.clamp_min(qn + vn - 2.0 * dots, 0.0)
    order = torch.where(candidates < 0, float("inf"), order)
    bv, tl = topk(order, k, True)
    ti = torch.gather(torch.clamp_min(candidates, 0), 1, tl)
    if ip:
        bv = -bv
    return ivf.postprocess_distances(bv, metric), ti


def _gather_host(host_dataset, safe: np.ndarray, reader: bool, gap: int = 256) -> np.ndarray:
    """Rows ``safe`` [b, c] of a host source -> [b, c, d]. A reader
    (``read(start, count)``) is read in spans: ids closer than ``gap`` rows
    share one read."""
    if not reader:
        return np.asarray(host_dataset)[safe]
    uniq, inv = np.unique(safe.reshape(-1), return_inverse=True)
    brk = np.flatnonzero(np.diff(uniq) > gap)
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk, [len(uniq) - 1]])
    parts = []
    for s, e in zip(starts, ends):
        lo_id = int(uniq[s])
        block = host_dataset.read(lo_id, int(uniq[e]) - lo_id + 1)
        parts.append(np.asarray(block)[uniq[s:e + 1] - lo_id])
    return np.concatenate(parts)[inv.reshape(-1)].reshape(safe.shape + (-1,))


def refine_host(host_dataset, queries, candidates, k: int, metric="sqeuclidean",
                compute_dtype=torch.float32, batch: int = 8192, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank against a dataset that stays on the host
    (refine_host.hpp): per batch of queries only the candidate rows are
    gathered on the host and one [batch, c, d] f32 block is uploaded and
    scored on the card.

    ``host_dataset``: a numpy array or ``np.memmap`` [n, d], or an object with
    ``read(start, count) -> [count, d]``. Queries go to ``device`` (None: the
    card; a tensor keeps its device). Invalid (negative) candidates score
    +inf and report id 0, as ``refine`` does."""
    metric = normalize_metric(metric)
    queries = _on_device(queries, device)
    dev = queries.device
    cand = candidates.cpu().numpy() if isinstance(candidates, torch.Tensor) \
        else np.asarray(candidates)
    nq, c = cand.shape
    if k > c:
        raise ValueError(f"k={k} > candidate count {c}")
    reader = hasattr(host_dataset, "read") and not isinstance(host_dataset, np.ndarray)
    out_d, out_i = [], []
    for lo in range(0, nq, batch):
        cb = cand[lo:lo + batch]
        vecs = _gather_host(host_dataset, np.maximum(cb, 0), reader)
        d, i = _refine_rows_impl(torch.from_numpy(np.asarray(vecs, np.float32)).to(dev),
                                 queries[lo:lo + batch], torch.from_numpy(cb).to(dev), int(k),
                                 metric, compute_dtype)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)
