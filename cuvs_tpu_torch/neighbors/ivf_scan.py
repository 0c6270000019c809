"""Cluster-major IVF scan — port of the fused path of ``cuvs_tpu.neighbors.ivf_scan``.

The (query, probe) pairs are grouped by list into fixed-width pair tiles
(``group_pairs_tiled``); each tile is scored against its list's window by the
fused scan kernel (``ops.ivf_scan``), which keeps the best ``cap`` rows per
strided lane bin; a final top-k over each query's per-probe pools picks the
result.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.selection.select_k import topk


def _round_window_up(window: int, n_pad: int) -> int:
    """Width of the fused scan's window: window + 128 (room for the 128-row
    aligned start), rounded up to a multiple of 512 where the array allows."""
    base = window + 128
    rounded = -(-base // 512) * 512
    return rounded if rounded <= n_pad else base


def group_pairs_tiled(probe_ids: torch.Tensor, n_lists: int, m_tile: int, n_tiles: int):
    """Group (query, probe) pairs by list into fixed-width tiles.

    A list probed by c pairs gets ceil(c/m_tile) tiles of m_tile slots, in
    query order; tiles are laid out list by list.

    Returns:
      tile_cluster: [n_tiles] list per tile (-1 = empty)
      qidx:         [n_tiles, m_tile] query per slot (-1 = empty)
      pair_tile:    [nq, p] tile of each pair (n_tiles = dropped)
      pair_slot:    [nq, p] slot of each pair within its tile
    all int32. With the callers' bound n_tiles = pairs//m_tile + n_lists + 1
    no pair is dropped.
    """
    nq, p = probe_ids.shape
    dev = probe_ids.device
    flat_c = probe_ids.reshape(-1).long()
    flat_q = torch.arange(nq, device=dev).repeat_interleave(p)
    order = torch.argsort(flat_c, stable=True)
    c_s = flat_c[order]
    q_s = flat_q[order]
    idx = torch.arange(nq * p, device=dev)
    first = torch.ones_like(c_s, dtype=torch.bool)
    first[1:] = c_s[1:] != c_s[:-1]
    group_start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = idx - group_start
    occ = torch.bincount(flat_c, minlength=n_lists)
    ntiles_c = -(-occ // m_tile)
    tile_base = torch.cumsum(ntiles_c, 0) - ntiles_c
    tile_idx = tile_base[c_s] + rank // m_tile
    slot = rank % m_tile
    keep = tile_idx < n_tiles
    row = torch.where(keep, tile_idx, n_tiles)  # row n_tiles collects dropped pairs
    tile_cluster = torch.full((n_tiles + 1,), -1, dtype=torch.int64, device=dev)
    tile_cluster[row] = c_s
    qidx = torch.full((n_tiles + 1, m_tile), -1, dtype=torch.int64, device=dev)
    qidx[row, torch.where(keep, slot, 0)] = q_s
    pair_tile = torch.empty_like(flat_c)
    pair_tile[order] = row
    pair_slot = torch.empty_like(flat_c)
    pair_slot[order] = slot
    return (tile_cluster[:n_tiles].to(torch.int32), qidx[:n_tiles].to(torch.int32),
            pair_tile.reshape(nq, p).to(torch.int32), pair_slot.reshape(nq, p).to(torch.int32))


def cluster_major_scan_fused(sorted_data, sorted_norms, lists: ivf.SortedLists, queries_f32,
                             probe_ids, k: int, metric, window: int, m_tile: int,
                             compute_dtype, n_tiles: int, recall_target=None, q_scale=None,
                             bin_cap=None, prefilter=None, overfetch: int = 4
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-Flat search through the fused scan kernel. Returns (dists [nq,k],
    ids [nq,k] int32). L2 family + InnerProduct.

    Per-probe candidates are per-128-row-bin bests (pair with refine() for
    the last recall digit). A bitset filter folds into the kernel's per-row
    penalty (filtered rows carry +inf). Bitmap/UDF filters mask the pool after
    the scan: it is over-fetched by ``overfetch``x, masked and re-selected.
    """
    from cuvs_tpu_torch.ops import ivf_scan as ops_ivf_scan

    nq, d = queries_f32.shape
    p = probe_ids.shape[1]
    n_lists = lists.offsets.shape[0]
    ip = metric == DistanceType.InnerProduct
    n_pad, dp = sorted_data.shape
    W_k = _round_window_up(window, n_pad)

    flt = None if (prefilter is None or prefilter.is_none) else prefilter
    bitset_mode = flt is not None and flt.kind == "bitset"
    post_mode = flt is not None and not bitset_mode
    ip_kernel = ip
    if bitset_mode:
        from cuvs_tpu_torch.core import bitset as _bs

        # poison filtered rows' penalty; IP has no norm term, so it runs the
        # L2 penalty path with zero norms and order values -2 q.y, halved below
        m = min(lists.ids.shape[0], sorted_norms.shape[0])
        valid_rows = _bs.bitset_test(flt.bits.to(sorted_norms.device), lists.ids[:m])
        base = torch.zeros_like(sorted_norms) if ip else sorted_norms.clone()
        base[:m] = torch.where(valid_rows, base[:m], float("inf"))
        sorted_norms = base
        ip_kernel = False

    tile_cluster, qidx, pair_tile, pair_slot = group_pairs_tiled(probe_ids, n_lists, m_tile,
                                                                 n_tiles)
    # per-tile window: 128-row aligned start, clamped to the array
    safe_c = torch.clamp(tile_cluster, 0, n_lists - 1).long()
    start = lists.offsets[safe_c]
    al = torch.minimum((start // 128) * 128,
                       torch.tensor(((n_pad - W_k) // 128) * 128, dtype=start.dtype,
                                    device=start.device))
    lo = start - al
    sizes = torch.where(tile_cluster >= 0, lists.sizes[safe_c], 0)

    qp = (torch.nn.functional.pad(queries_f32, (0, dp - d)) if dp != d else queries_f32)
    if q_scale is not None:
        qc = torch.clamp(torch.round(qp / q_scale), -127, 127).to(torch.int8)
        scale2 = q_scale * q_scale
        int8_mode = True
    else:
        qc = qp.to(compute_dtype)
        scale2 = torch.ones((), dtype=torch.float32, device=qp.device)
        int8_mode = False
    # strided lane bins: every window exposes 128 bins, so cap 2 covers
    # k <= ~32 with negligible collision loss
    cap = int(bin_cap) if bin_cap else int(min(32, max(2, -(-k // 32))))
    out_v, out_i = ops_ivf_scan.fused_ivf_scan(
        sorted_data, sorted_norms, qc, qidx, al, lo, sizes, scale2, W=W_k, m_tile=m_tile,
        ip=ip_kernel, int8_mode=int8_mode, cap=cap)
    Fc = cap * 128

    # sentinel tile row for dropped pairs (cannot occur at the default bound)
    out_v = torch.cat([out_v, torch.full((1,) + out_v.shape[1:], float("inf"),
                                         device=out_v.device)])
    out_i = torch.cat([out_i, torch.zeros((1,) + out_i.shape[1:], dtype=out_i.dtype,
                                          device=out_i.device)])
    pt, ps = pair_tile.long(), pair_slot.long()
    pv = out_v[pt, ps].reshape(nq, p * Fc)
    po = out_i[pt, ps].reshape(nq, p * Fc)

    kk = min(k, p * Fc)
    fetch = min(p * Fc, max(k * overfetch, k)) if post_mode else kk
    tv, tl = topk(pv, fetch, True, recall_target)
    ok = torch.isfinite(tv)
    # pool column = probe j * Fc + rank r * 128 + lane; stored uint8 = slice
    al_pad = torch.cat([al, al.new_zeros(1)])
    tile_sel = torch.gather(pt, 1, tl // Fc)
    off = torch.gather(po, 1, tl).long()
    pos = al_pad[tile_sel] + off * 128 + (tl % Fc) % 128
    fi = torch.where(ok, lists.ids[torch.where(ok, pos, 0)], 0).to(torch.int32)

    if bitset_mode and ip:
        tv = tv * 0.5  # scored -2 q.y through the L2 penalty path
    if post_mode:
        qid = torch.arange(nq, device=fi.device)
        mask = filt.passes(flt, qid[:, None], fi)
        tv = torch.where(ok & mask, tv, float("inf"))
        tv, srt = torch.sort(tv, dim=1, stable=True)
        fi = torch.gather(fi, 1, srt)
        tv, fi = tv[:, :kk], fi[:, :kk]
        ok = torch.isfinite(tv)

    if ip:
        fv = torch.where(ok, -tv, float("-inf"))
    else:
        qn = (queries_f32 * queries_f32).sum(1)
        fv = ivf.postprocess_distances(torch.clamp_min(tv + qn[:, None], 0.0), metric)
    if kk < k:
        fv = torch.nn.functional.pad(fv, (0, k - kk), value=float("-inf") if ip else float("inf"))
        fi = torch.nn.functional.pad(fi, (0, k - kk))
    return fv, fi
