"""Cluster-major IVF scan — port of the fused paths of ``cuvs_tpu.neighbors.ivf_scan``.

The (query, probe) pairs are grouped by list into fixed-width pair tiles
(``group_pairs_tiled``); each tile is scored against its list's window by a
fused scan kernel (``ops.ivf_scan``: raw rows for IVF-Flat, packed codes for
IVF-PQ and IVF-RaBitQ), which keeps the best ``cap`` rows per strided lane
bin; a final top-k over each query's per-probe pools picks the result.

The quantized indexes' serving layout (``pack_codes_transposed``,
``decoded_norms``) drops the reference's TPU padding (word rows to a multiple
of 8, norms to a 1024-row DMA window): the kernel reads words and norms by
plain index. Padded arrays carried over from the reference work unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuvs_tpu_torch.core import bitpack, bitset
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


def _tile_windows(tile_cluster, lists: ivf.SortedLists, n_pad: int, W_k: int):
    """Per-tile window: (list id clamped into range, 128-row aligned start
    clamped to the array, first valid window position, list size; 0 for an
    empty tile)."""
    n_lists = lists.offsets.shape[0]
    safe_c = torch.clamp(tile_cluster, 0, n_lists - 1).long()
    start = lists.offsets[safe_c]
    al = torch.clamp_max((start // 128) * 128, ((n_pad - W_k) // 128) * 128)
    sizes = torch.where(tile_cluster >= 0, lists.sizes[safe_c], 0)
    return safe_c, al, start - al, sizes


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

    d = queries_f32.shape[1]
    n_lists = lists.offsets.shape[0]
    ip = metric == DistanceType.InnerProduct
    n_pad, dp = sorted_data.shape
    W_k = _round_window_up(window, n_pad)

    flt = None if (prefilter is None or prefilter.is_none) else prefilter
    bitset_mode = flt is not None and flt.kind == "bitset"
    post_mode = flt is not None and not bitset_mode
    ip_kernel = ip
    if bitset_mode:
        # poison filtered rows' penalty; IP has no norm term, so it runs the
        # L2 penalty path with zero norms and order values -2 q.y, halved below
        sorted_norms = _poisoned(flt, lists, sorted_norms, zeros=ip)
        ip_kernel = False

    tile_cluster, qidx, pair_tile, pair_slot = group_pairs_tiled(probe_ids, n_lists, m_tile,
                                                                 n_tiles)
    _, al, lo, sizes = _tile_windows(tile_cluster, lists, n_pad, W_k)

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
    return _flat_pool(out_v, out_i, pair_tile, pair_slot, al, lists, queries_f32, k, metric, ip,
                      cap, recall_target, flt if post_mode else None, bitset_mode, overfetch)


def _flat_pool(out_v, out_i, pair_tile, pair_slot, al, lists: ivf.SortedLists, queries_f32,
               k: int, metric, ip: bool, cap: int, recall_target, post_filter, bitset_mode: bool,
               overfetch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Postlude of the flat fused scan: sentinel-pad the tile pool, cross-probe
    top-k, recover global ids from (window start, 128-slice, lane), add |q|^2
    (L2). ``post_filter`` (bitmap/udf) masks an ``overfetch``x deep pool
    before the final cut."""
    nq, p = pair_tile.shape
    post_mode = post_filter is not None
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
        mask = filt.passes(post_filter, qid[:, None], fi)
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


def block_diag_codebook(pq_centers, dp: int, dtype=torch.bfloat16) -> torch.Tensor:
    """[S, book, pq_len] per-subspace codebook -> transposed block-diagonal
    [dp, S*book] (contiguous): column s*book + c holds codebook row (s, c) at
    dims [s*pq_len, (s+1)*pq_len), zeros elsewhere."""
    S, book, pq_len = pq_centers.shape
    dev = pq_centers.device
    cb = torch.zeros((S, book, dp), dtype=torch.float32, device=dev)
    dims = torch.arange(S, device=dev)[:, None] * pq_len + torch.arange(pq_len, device=dev)
    cb.scatter_(2, dims[:, None, :].expand(S, book, pq_len), pq_centers.float())
    return cb.reshape(S * book, dp).T.contiguous().to(dtype)


def pack_codes_transposed(codes_sorted, window: int) -> torch.Tensor:
    """[n, S] uint8 list-sorted codes -> [ceil(S/4), n + window] int32 words
    (the raw code bytes, four to a word, little-endian; ``window`` zero
    columns at the end), the fused PQ kernel's coalesced per-word-row
    layout. No pad of the word rows: the kernel needs none."""
    padded = torch.nn.functional.pad(torch.as_tensor(codes_sorted).long(), (0, 0, 0, window))
    return bitpack.pack(padded, 8).T.contiguous()


def decoded_norms(codes_sorted, pq_centers, window: int, W_k: int) -> torch.Tensor:
    """Squared norms of the decoded residuals [n + window] f32 (``window``
    zeros at the end): subspace dims are disjoint, so |y|^2 = sum_s
    |codebook[s, code_s]|^2, summed over s in order as the reference does.
    ``W_k`` is the reference's DMA-window argument; the port reads norms by
    row and needs no pad for it."""
    norm_tab = (pq_centers * pq_centers).sum(2)  # [S, book]
    codes = torch.as_tensor(codes_sorted).long()
    nrm = torch.zeros((codes.shape[0],), dtype=torch.float32, device=codes.device)
    for s in range(codes.shape[1]):
        nrm = nrm + norm_tab[s, codes[:, s]]
    return torch.nn.functional.pad(nrm, (0, window))


def _rotated_operands(queries_f32, rotation, centers_rot, safe_c):
    """Rotated queries (f32 [nq, rot_dim]) and the kernel's bf16 operands
    padded to dp = rot_dim rounded up to 128: queries [nq, dp] and the tiles'
    rotated centers [n_tiles, dp]."""
    rot_dim = rotation.shape[0]
    dp = -(-rot_dim // 128) * 128
    qrot = queries_f32 @ rotation.T
    qrot_p = torch.nn.functional.pad(qrot, (0, dp - rot_dim)).to(torch.bfloat16)
    crot_p = torch.nn.functional.pad(centers_rot, (0, dp - rot_dim)).to(torch.bfloat16)
    return qrot, qrot_p, crot_p[safe_c], dp


def _poisoned(flt, lists: ivf.SortedLists, arr: torch.Tensor, zeros: bool) -> torch.Tensor:
    """A copy of a per-row array of the sorted rows (zeros instead with
    ``zeros``) holding +inf on the rows a bitset filter drops. The index's own
    array is never written."""
    m = min(lists.ids.shape[0], arr.shape[0])
    keep = bitset.bitset_test(flt.bits.to(arr.device), lists.ids[:m])
    out = torch.zeros_like(arr) if zeros else arr.clone()
    out[:m] = torch.where(keep, out[:m], float("inf"))
    return out


def cluster_major_scan_pq_fused(codes_t, sorted_norms, centers_rot, pq_centers, rotation,
                                lists: ivf.SortedLists, queries_f32, probe_ids, k: int, metric,
                                window: int, m_tile: int, n_tiles: int, recall_target=None,
                                bin_cap=None, book: int = 256, prefilter=None,
                                overfetch: int = 4, fused_dtype: str = "bf16"
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ search through the fused PQ scan kernel (PER_SUBSPACE
    codebooks, L2 family + InnerProduct). Rankings are ADC-approximate: pair
    with refine() for the last recall digits. ``fused_dtype="int8"`` runs
    the kernel's int8 lookup table (one scale per tile).

    Filters: a bitset folds into the kernel's per-row penalty (IP carries a
    0/+inf penalty on the norm channel, ``use_pen``); bitmap/udf mask an
    over-fetched pool after the scan (see cluster_major_scan_fused). The
    index's norms are never written."""
    from cuvs_tpu_torch.ops import ivf_scan as ops_ivf_scan

    n_lists = lists.offsets.shape[0]
    ip = metric == DistanceType.InnerProduct
    n_pad = codes_t.shape[1]
    W_k = _round_window_up(window, n_pad)
    tile_cluster, qidx, pair_tile, pair_slot = group_pairs_tiled(probe_ids, n_lists, m_tile,
                                                                 n_tiles)
    safe_c, al, lo, sizes = _tile_windows(tile_cluster, lists, n_pad, W_k)
    qrot, qrot_p, centers_tile, dp = _rotated_operands(queries_f32, rotation, centers_rot, safe_c)
    cb_t = block_diag_codebook(pq_centers, dp)

    flt = None if (prefilter is None or prefilter.is_none) else prefilter
    bitset_mode = flt is not None and flt.kind == "bitset"
    use_pen = bitset_mode and ip
    if bitset_mode:
        # IP scoring has no norm term: the norm channel carries a 0/+inf
        # filter penalty instead (the kernel's use_pen path)
        sorted_norms = _poisoned(flt, lists, sorted_norms, zeros=ip)

    cap = int(bin_cap) if bin_cap else int(min(32, max(2, -(-k // 32))))
    out_v, out_i = ops_ivf_scan.fused_pq_scan(
        codes_t, sorted_norms, qrot_p, cb_t, centers_tile, qidx, al, lo, sizes, W=W_k,
        m_tile=m_tile, ip=ip, cap=cap, book=book, use_pen=use_pen,
        int8_mode=fused_dtype == "int8", pq_len=pq_centers.shape[2])
    # per-(query, probe) cluster term: L2 adds |Rq - c_rot|^2, IP -q.c
    offs = _cluster_offsets(qrot, centers_rot, probe_ids, ip)
    return _pool_with_offsets(out_v, out_i, pair_tile, pair_slot, al, lists, offs, k, metric, ip,
                              cap, recall_target,
                              post_filter=flt if (flt is not None and not bitset_mode) else None,
                              overfetch=overfetch)


def _cluster_offsets(qrot, centers_rot, probe_ids, ip: bool) -> torch.Tensor:
    """Per-(query, probe) cluster term added outside the quantized kernels
    [nq, p]: -q.center for IP ranking, |Rq - c_rot|^2 for L2."""
    qcd = qrot @ centers_rot.T
    pids = probe_ids.long()
    sel = torch.gather(qcd, 1, pids)
    if ip:
        return -sel
    qn = (qrot * qrot).sum(1)
    cn = (centers_rot * centers_rot).sum(1)
    return qn[:, None] + cn[pids] - 2.0 * sel


def _pool_with_offsets(out_v, out_i, pair_tile, pair_slot, al, lists: ivf.SortedLists, offs,
                       k: int, metric, ip: bool, cap: int, recall_target, post_filter=None,
                       overfetch: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Postlude of the quantized fused scans: sentinel-pad the tile pool, add
    the per-probe offsets, cross-probe top-k, recover global ids from
    (window start, 128-slice, lane). Unlike the flat scan's postlude it adds
    no |q|^2 (the offsets carry the query terms) and clamps L2 at 0 only for
    finite entries. ``post_filter`` (bitmap/udf) masks an ``overfetch``x
    deep pool before the final cut."""
    nq, p = pair_tile.shape
    Fc = cap * 128
    out_v = torch.cat([out_v, torch.full((1,) + out_v.shape[1:], float("inf"),
                                         device=out_v.device)])
    out_i = torch.cat([out_i, torch.zeros((1,) + out_i.shape[1:], dtype=out_i.dtype,
                                          device=out_i.device)])
    pt, ps = pair_tile.long(), pair_slot.long()
    pv = (out_v[pt, ps] + offs[:, :, None]).reshape(nq, p * Fc)
    po = out_i[pt, ps].reshape(nq, p * Fc)

    kk = min(k, p * Fc)
    fetch = min(p * Fc, max(k * overfetch, k)) if post_filter is not None else kk
    tv, tl = topk(pv, fetch, True, recall_target)
    ok = torch.isfinite(tv)
    al_pad = torch.cat([al, al.new_zeros(1)])
    tile_sel = torch.gather(pt, 1, tl // Fc)
    off = torch.gather(po, 1, tl).long()
    pos = al_pad[tile_sel] + off * 128 + (tl % Fc) % 128
    fi = torch.where(ok, lists.ids[torch.where(ok, pos, 0)], 0).to(torch.int32)

    if post_filter is not None:
        qid = torch.arange(nq, device=fi.device)
        mask = filt.passes(post_filter, qid[:, None], fi)
        tv = torch.where(ok & mask, tv, float("inf"))
        tv, srt = torch.sort(tv, dim=1, stable=True)
        fi = torch.gather(fi, 1, srt)
        tv, fi = tv[:, :kk], fi[:, :kk]
        ok = torch.isfinite(tv)

    if ip:
        fv = torch.where(ok, -tv, float("-inf"))
    else:
        fv = ivf.postprocess_distances(torch.where(ok, torch.clamp_min(tv, 0.0), float("inf")),
                                       metric)
    if kk < k:
        fv = torch.nn.functional.pad(fv, (0, k - kk), value=float("-inf") if ip else float("inf"))
        fi = torch.nn.functional.pad(fi, (0, k - kk))
    return fv, fi


def cluster_major_scan_rabitq_fused(codes_t, sorted_fa, sorted_fr, centers_rot, rotation,
                                    lists: ivf.SortedLists, queries_f32, probe_ids, k: int,
                                    metric, window: int, m_tile: int, n_tiles: int, bits: int,
                                    recall_target=None, bin_cap=None, prefilter=None,
                                    overfetch: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-RaBitQ search through the fused quantized-code kernel: the decode
    matrix carries the centred levels xu = level + k_b (k_b = -(2^bits-1)/2),
    and the kernel's epilogue is the unbiased estimator's window part
    fa + fr*<q_rot, xu>. ``sorted_fa``/``sorted_fr`` are the metric-effective
    factors: (f_add, f_rescale) for L2, (0, 0.5*f_rescale) for IP. A bitset
    filter folds into a copy of fa (+inf on filtered rows)."""
    from cuvs_tpu_torch.ops import ivf_scan as ops_ivf_scan

    n_lists = lists.offsets.shape[0]
    ip = metric == DistanceType.InnerProduct
    rot_dim = rotation.shape[0]
    n_pad = codes_t.shape[1]
    W_k = _round_window_up(window, n_pad)
    book = 1 << bits
    tile_cluster, qidx, pair_tile, pair_slot = group_pairs_tiled(probe_ids, n_lists, m_tile,
                                                                 n_tiles)
    safe_c, al, lo, sizes = _tile_windows(tile_cluster, lists, n_pad, W_k)
    qrot, qrot_p, centers_tile, dp = _rotated_operands(queries_f32, rotation, centers_rot, safe_c)
    kb = -((1 << bits) - 1) / 2.0
    levels = torch.arange(book, dtype=torch.float32, device=qrot.device) + kb
    cb_t = block_diag_codebook(levels[None, :, None].expand(rot_dim, book, 1), dp)

    flt = None if (prefilter is None or prefilter.is_none) else prefilter
    bitset_mode = flt is not None and flt.kind == "bitset"
    if bitset_mode:  # -(fa + fr*dots) is -inf on filtered rows whatever the metric
        sorted_fa = _poisoned(flt, lists, sorted_fa, zeros=False)

    cap = int(bin_cap) if bin_cap else int(min(32, max(2, -(-k // 32))))
    out_v, out_i = ops_ivf_scan.fused_pq_scan(
        codes_t, sorted_fa, qrot_p, cb_t, centers_tile, qidx, al, lo, sizes, W=W_k,
        m_tile=m_tile, ip=ip, cap=cap, book=book, bits=bits, mode="rabitq", sorted_fr=sorted_fr,
        pq_len=1)
    offs = _cluster_offsets(qrot, centers_rot, probe_ids, ip)
    return _pool_with_offsets(out_v, out_i, pair_tile, pair_slot, al, lists, offs, k, metric, ip,
                              cap, recall_target,
                              post_filter=flt if (flt is not None and not bitset_mode) else None,
                              overfetch=overfetch)


def cluster_major_scan_pq(*args, **kw):
    """The reference's unfused decode-and-dot IVF-PQ scan: not ported yet
    (ROADMAP.md queue 1 #4). IVF-PQ searches through
    ``cluster_major_scan_pq_fused`` or ivf_pq's query-major scan."""
    raise NotImplementedError("cluster_major_scan_pq is not ported yet (ROADMAP.md queue 1 #4); "
                              "use scan_algo='fused' or 'query_major'")
