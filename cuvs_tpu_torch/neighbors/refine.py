"""Exact re-ranking of candidate lists — port of ``cuvs_tpu.neighbors.refine``.

A candidate list is a gather: the [nq, c, d] candidate rows are dotted with
their query, scored by the exact metric, and the best k kept (refine.hpp:62).
An invalid (negative) candidate slot scores +inf and, as in the reference,
reports id 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


def _refine_impl(dataset, queries, candidates, k, metric, compute_dtype, qchunk):
    n = dataset.shape[0]
    ip = metric == DistanceType.InnerProduct
    out_v, out_i = [], []
    for c0 in range(0, queries.shape[0], qchunk):
        q = queries[c0:c0 + qchunk].float()
        cand = candidates[c0:c0 + qchunk]
        invalid = cand < 0
        safe = torch.clamp(cand.long(), 0, n - 1)
        vecs = dataset[safe].float()  # [B, c, d]
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
        order = torch.where(invalid, float("inf"), order)
        tv, tl = topk(order, k, True)
        out_v.append(tv)
        out_i.append(torch.gather(safe, 1, tl).to(candidates.dtype))
    bv = torch.cat(out_v)
    if ip:
        bv = -bv
    return ivf.postprocess_distances(bv, metric), torch.cat(out_i)


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
