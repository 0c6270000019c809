"""Pool top-k: the pool merge of the fused IVF searches.

The fused scans (``ops.ivf_scan``) leave a pool ``out_v [n_tiles, M, F]`` of
per-(tile, slot) candidates; a query's candidates are the rows its pairs
landed on. ``pool_topk`` keeps, per query, the ``fetch`` best entries of the
virtual pool

    pv[q, j*F + c] = out_v[pair_tile[q, j], pair_slot[q, j], c] + offs[q, j]

(a dropped pair, ``pair_tile == n_tiles``, reads +inf), as
``select_k.topk(pv, fetch, True)`` does: ascending, ties to the lower column.

For CUDA tensors it launches the hand-written kernel ``csrc/pool_topk.cu``,
which reads the pools where they lie and forms neither the padded pool nor
pv; it takes every fetch the fused scans' bins can fill (up to 4096, the
kernel's ``kMaxK``) and raises on a wider one. CPU tensors run the plain
version, ``pool_topk_reference``: pad, gather, stable sort.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.ops import _lib
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils import tracing

# Kernel launches since the last reset (see ops.bf_topk.LAUNCHES).
LAUNCHES = {"pool_topk": 0}


def pool_topk(out_v: torch.Tensor, pair_tile: torch.Tensor, pair_slot: torch.Tensor,
              offs: Optional[torch.Tensor], fetch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``min(fetch, p*F)`` best entries of each query's pool, best first.

    out_v [n_tiles, M, F] f32; pair_tile, pair_slot [nq, p] int32 (tile
    n_tiles: a dropped pair); offs [nq, p] f32 added to each pair's row, or
    None. Returns (values [nq, fetch] f32, pool columns [nq, fetch] int64).
    """
    if not out_v.is_cuda:
        return pool_topk_reference(out_v, pair_tile, pair_slot, offs, fetch)
    nq, p = pair_tile.shape
    n_tiles, M, F = out_v.shape
    kk = min(fetch, p * F)
    dev = out_v.device
    if out_v.dtype != torch.float32 or not out_v.is_contiguous() or out_v.data_ptr() % 16:
        raise ValueError("out_v must be a contiguous, 16-byte aligned float32 pool")
    if F % 128 or p * F >= 2 ** 31 or n_tiles * M >= 2 ** 31:
        raise ValueError(f"need F a multiple of 128 and p*F, n_tiles*M below 2^31 "
                         f"(F={F}, p={p}, n_tiles*M={n_tiles * M})")
    if pair_slot.shape != (nq, p) or (offs is not None and offs.shape != (nq, p)):
        raise ValueError("pair_slot and offs must be [nq, p] as pair_tile")
    operands = [pair_tile, pair_slot] + ([offs] if offs is not None else [])
    if any(t.device != dev for t in operands):
        raise ValueError(f"pair_tile, pair_slot and offs must lie on {dev}")
    tiles = pair_tile.to(torch.int32).contiguous()
    slots = pair_slot.to(torch.int32).contiguous()
    offs_c = offs.to(torch.float32).contiguous() if offs is not None else None
    tv = torch.empty((nq, kk), dtype=torch.float32, device=dev)
    tl = torch.empty((nq, kk), dtype=torch.int64, device=dev)
    if nq == 0 or kk == 0:
        return tv, tl
    rc = _lib.lib().cuvs_pool_topk(
        out_v.data_ptr(), n_tiles, M, F, tiles.data_ptr(), slots.data_ptr(),
        offs_c.data_ptr() if offs_c is not None else None, nq, p, kk, tv.data_ptr(),
        tl.data_ptr(), _lib.stream(dev))
    _lib.check(rc, "pool_topk")
    LAUNCHES["pool_topk"] += 1
    tracing.count("merge_kernel_queries", nq)
    return tv, tl


def pool_topk_reference(out_v: torch.Tensor, pair_tile: torch.Tensor, pair_slot: torch.Tensor,
                        offs: Optional[torch.Tensor], fetch: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``pool_topk`` (same contract): pad the pool
    with a +inf tile for the dropped pairs, gather each query's rows, add the
    offsets, stable sort."""
    nq, p = pair_tile.shape
    F = out_v.shape[2]
    padded = torch.cat([out_v, torch.full((1,) + out_v.shape[1:], float("inf"),
                                          device=out_v.device)])
    pv = padded[pair_tile.long(), pair_slot.long()]
    if offs is not None:
        pv = pv + offs[:, :, None]
    return topk(pv.reshape(nq, p * F), fetch, True)
