"""Batched top-k selection — port of ``cuvs_tpu.selection.select_k``.

Selection is exact everywhere: a stable sort, so among equal values the lower
position comes first, as ``lax.top_k`` orders them. ``recall_target < 1``
selects the TPU's approximate partial reduction (``lax.approx_min_k``) in the
reference, which is exact on the CPU; this port keeps the argument for the
same signatures and always returns the exact top-k.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def topk(values: torch.Tensor, k: int, select_min: bool,
         recall_target: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k on the last axis. Returns (values, positional int64 indices),
    best first, ties to the lower position. ``recall_target`` is accepted and
    ignored (the selection is exact)."""
    kk = min(k, values.shape[-1])
    v, i = torch.sort(values, dim=-1, descending=not select_min, stable=True)
    return v[..., :kk], i[..., :kk]


def _pad_to(x: torch.Tensor, size: int, fill) -> torch.Tensor:
    pad = size - x.shape[1]
    if pad <= 0:
        return x
    return torch.cat([x, torch.full((x.shape[0], pad), fill, dtype=x.dtype, device=x.device)], 1)


def select_k(values, k: int, select_min: bool = True, indices: Optional[torch.Tensor] = None,
             len_i: Optional[torch.Tensor] = None, recall_target: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest (or largest) values per row.

    Args:
      values: [batch, len] float tensor (or [len]).
      k: number of elements to select.
      select_min: True = k smallest (distances), False = k largest (IP).
      indices: optional [batch, len] payload ids; defaults to positions.
      len_i: optional [batch] valid lengths; elements beyond are ignored.
      recall_target: accepted for parity; the selection is exact.

    Returns:
      (values [batch, k] sorted best-first, indices [batch, k] int32 or the
      payload's dtype). Rows shorter than k are padded with +/-inf and id 0.
    """
    values = torch.as_tensor(values)
    squeeze = values.ndim == 1
    if squeeze:
        values = values[None]
    values = values.float()
    n = values.shape[1]
    if len_i is not None:
        len_i = torch.as_tensor(len_i, device=values.device)
        valid = torch.arange(n, device=values.device)[None, :] < len_i[:, None]
        values = torch.where(valid, values, float("inf") if select_min else float("-inf"))
    v, pos = topk(values, k, select_min, recall_target)
    if indices is not None:
        out_i = torch.gather(torch.as_tensor(indices, device=values.device), 1, pos)
    else:
        out_i = pos.to(torch.int32)
    v = _pad_to(v, k, float("inf") if select_min else float("-inf"))
    out_i = _pad_to(out_i, k, 0)
    if squeeze:
        return v[0], out_i[0]
    return v, out_i


def merge_parts(values_parts, indices_parts, k: int, select_min: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-part top-k results into one top-k (knn_merge_parts).

    Parts are a list of [batch, k_i] tensors or stacked [n_parts, batch, k_i].
    Ids must already be global."""
    if isinstance(values_parts, (list, tuple)):
        vals = torch.cat([torch.as_tensor(v) for v in values_parts], dim=-1)
        idxs = torch.cat([torch.as_tensor(i) for i in indices_parts], dim=-1)
    else:
        vp = torch.as_tensor(values_parts)
        ip = torch.as_tensor(indices_parts)
        vals = torch.movedim(vp, 0, -2).reshape(*vp.shape[1:-1], -1)
        idxs = torch.movedim(ip, 0, -2).reshape(*ip.shape[1:-1], -1)
    return select_k(vals, k, select_min=select_min, indices=idxs)
