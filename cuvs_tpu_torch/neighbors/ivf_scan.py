"""Cluster-major IVF scan — port of ``cuvs_tpu.neighbors.ivf_scan``.

The (query, probe) pairs are grouped by list into fixed-width pair tiles
(``group_pairs_tiled``); each tile is scored against its list's window by a
fused scan kernel (``ops.ivf_scan``: raw rows for IVF-Flat, packed codes for
IVF-PQ and IVF-RaBitQ), which keeps the best ``cap`` rows per strided lane
bin; a final top-k over each query's per-probe pools picks the result.

``scan_path`` is the rule by which IVF-Flat, IVF-PQ and IVF-RaBitQ pick
their scan, and ``tile_geometry`` sizes the pair tiles of the tiled paths.

The unfused scans (``cluster_major_scan``, ``cluster_major_scan_tiled``,
``cluster_major_scan_pq``) score a chunk of lists or tiles by one batched
product in PyTorch: they serve what the kernels do not (cosine, metric UDFs,
per-cluster PQ codebooks, indexes without a serving layout).

The quantized indexes' serving layout (``pack_codes_transposed``,
``decoded_norms``) drops the reference's TPU padding (word rows to a multiple
of 8, norms to a 1024-row DMA window): the kernel reads words and norms by
plain index. Padded arrays carried over from the reference work unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cuvs_tpu_torch.core import bitpack, bitset
from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.ops import pool_topk as ops_pool
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils import tracing

# the metrics the fused kernels have epilogues for
FUSED_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                 DistanceType.InnerProduct)


def scan_path(algo: str, nq: int, n_probes: int, n_lists: int, fused_ok: bool, on_cuda: bool,
              fallback: str) -> str:
    """The scan that serves an IVF search: "query_major", "cluster_major" or
    "fused". "auto" takes query_major for small batches (nq * n_probes < 4 *
    n_lists), else fused where the family's ``fused_ok`` holds on a CUDA
    device, else the family's ``fallback``; an explicit "fused" the family
    cannot serve takes the fallback too. ``fallback`` is "cluster_major"
    (IVF-Flat, IVF-PQ) or "query_major" (IVF-RaBitQ, which has no unfused
    cluster-major scan)."""
    if algo not in ("auto", "query_major", "cluster_major", "fused"):
        raise ValueError(f"scan_algo {algo!r}: auto, query_major, cluster_major or fused")
    if algo == "auto":
        if nq * n_probes < 4 * n_lists:
            return "query_major"
        return "fused" if fused_ok and on_cuda else fallback
    if algo == "fused" and not fused_ok:
        return fallback
    return algo


def _round_window_up(window: int, n_pad: int) -> int:
    """Width of the fused scan's window: window + 128 (room for the 128-row
    aligned start), rounded up to a multiple of 512 where the array allows."""
    base = window + 128
    rounded = -(-base // 512) * 512
    return rounded if rounded <= n_pad else base


def max_occupancy(probe_ids: torch.Tensor, n_lists: int) -> torch.Tensor:
    """Largest number of (query, probe) pairs landing on one list (0-d).
    Callers size ``group_pairs``' slot axis with it so no pair is dropped."""
    return torch.bincount(probe_ids.reshape(-1).long(), minlength=n_lists).max()


def _rank_in_group(flat_c: torch.Tensor):
    """Stable sort of the pairs by list: (order, sorted lists, rank of each
    sorted pair within its list)."""
    order = torch.argsort(flat_c, stable=True)
    c_s = flat_c[order]
    idx = torch.arange(c_s.shape[0], device=c_s.device)
    first = torch.ones_like(c_s, dtype=torch.bool)
    first[1:] = c_s[1:] != c_s[:-1]
    return order, c_s, idx - torch.cummax(torch.where(first, idx, 0), 0).values


def group_pairs(probe_ids: torch.Tensor, n_lists: int, max_per_cluster: int):
    """Group (query, probe) pairs by list, ``max_per_cluster`` slots each.

    Returns qidx [n_lists, M] (query per slot, -1 empty) and pair_slot
    [nq, p] (slot of each pair; M = dropped), both int32."""
    nq, p = probe_ids.shape
    dev = probe_ids.device
    flat_c = probe_ids.reshape(-1).long()
    flat_q = torch.arange(nq, device=dev).repeat_interleave(p)
    order, c_s, slot = _rank_in_group(flat_c)
    keep = slot < max_per_cluster
    qidx = torch.full((n_lists + 1, max_per_cluster), -1, dtype=torch.int64, device=dev)
    qidx[torch.where(keep, c_s, n_lists), torch.where(keep, slot, 0)] = flat_q[order]
    pair_slot = torch.empty_like(flat_c)
    pair_slot[order] = torch.where(keep, slot, max_per_cluster)
    return qidx[:n_lists].to(torch.int32), pair_slot.reshape(nq, p).to(torch.int32)


def group_pairs_tiled(probe_ids: torch.Tensor, n_lists: int, m_tile: int, n_tiles: int):
    """Group (query, probe) pairs by list into fixed-width tiles.

    A list probed by c pairs gets ceil(c/m_tile) tiles of m_tile slots, in
    query order; tiles are laid out list by list.

    Returns:
      tile_cluster: [n_tiles] list per tile (-1 = empty)
      qidx:         [n_tiles, m_tile] query per slot (-1 = empty)
      pair_tile:    [nq, p] tile of each pair (n_tiles = dropped)
      pair_slot:    [nq, p] slot of each pair within its tile
    all int32. With ``tile_geometry``'s n_tiles no pair is dropped.
    """
    nq, p = probe_ids.shape
    dev = probe_ids.device
    flat_c = probe_ids.reshape(-1).long()
    flat_q = torch.arange(nq, device=dev).repeat_interleave(p)
    order, c_s, rank = _rank_in_group(flat_c)
    q_s = flat_q[order]
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


def tile_geometry(nq: int, n_probes: int, n_lists: int) -> Tuple[int, int]:
    """(m_tile, n_tiles) for ``group_pairs_tiled`` over nq x n_probes pairs:
    tiles of nq slots clamped to [8, 128], and pairs // m_tile tiles plus one
    partial tile per probed list plus one, so no pair is dropped."""
    m_tile = int(min(128, max(8, nq)))
    pairs = nq * n_probes
    return m_tile, pairs // m_tile + min(n_lists, pairs) + 1


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


class _Tiles(NamedTuple):
    """A fused search's pair tiles and their windows (``group_pairs_tiled``,
    ``_tile_windows``), the kernel's window width ``W`` and bin cap ``cap``,
    and its prefilter split: a ``bitset`` folds into the kernel's per-row
    penalty, a bitmap/udf filter masks the pool after the scan (``post``)."""

    qidx: torch.Tensor
    pair_tile: torch.Tensor
    pair_slot: torch.Tensor
    safe_c: torch.Tensor
    al: torch.Tensor
    lo: torch.Tensor
    sizes: torch.Tensor
    W: int
    cap: int
    bitset: Optional[filt.Prefilter]
    post: Optional[filt.Prefilter]


def _fused_tiles(lists: ivf.SortedLists, probe_ids, n_pad: int, window: int, m_tile: int,
                 n_tiles: int, k: int, bin_cap, prefilter) -> _Tiles:
    """The plan every fused search shares (run under ``ivf::group``)."""
    flt = None if (prefilter is None or prefilter.is_none) else prefilter
    bitset_mode = flt is not None and flt.kind == "bitset"
    W_k = _round_window_up(window, n_pad)
    tile_cluster, qidx, pair_tile, pair_slot = group_pairs_tiled(
        probe_ids, lists.offsets.shape[0], m_tile, n_tiles)
    safe_c, al, lo, sizes = _tile_windows(tile_cluster, lists, n_pad, W_k)
    # strided lane bins: every window exposes 128 bins, so cap 2 covers
    # k <= ~32 with negligible collision loss
    cap = int(bin_cap) if bin_cap else int(min(32, max(2, -(-k // 32))))
    return _Tiles(qidx, pair_tile, pair_slot, safe_c, al, lo, sizes, W_k, cap,
                  flt if bitset_mode else None, None if bitset_mode else flt)


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

    ip = metric == DistanceType.InnerProduct
    with tracing.span("ivf::group"):
        t = _fused_tiles(lists, probe_ids, sorted_data.shape[0], window, m_tile, n_tiles, k,
                         bin_cap, prefilter)
        if t.bitset is not None:
            # poison filtered rows' penalty; IP has no norm term, so it runs the
            # L2 penalty path with zero norms and order values -2 q.y, halved
            # in the merge
            sorted_norms = _poisoned(t.bitset, lists, sorted_norms, zeros=ip)
        qc, _, scale2 = _flat_operands(sorted_data, queries_f32, metric, compute_dtype, q_scale)
        int8_mode = scale2 is not None
        if not int8_mode:
            scale2 = torch.ones((), dtype=torch.float32, device=qc.device)
    with tracing.span("ivf::scan"):
        out_v, out_i = ops_ivf_scan.fused_ivf_scan(
            sorted_data, sorted_norms, qc, t.qidx, t.al, t.lo, t.sizes, scale2, W=t.W,
            m_tile=m_tile, ip=ip and t.bitset is None, int8_mode=int8_mode, cap=t.cap)
    with tracing.span("ivf::merge"):
        return _merge_pools(out_v, out_i, t.pair_tile, t.pair_slot, t.al, lists, None, k, metric,
                            t.cap, t.post, overfetch, _flat_l2(queries_f32),
                            halve=ip and t.bitset is not None)


def _merge_pools(out_v, out_i, pair_tile, pair_slot, al, lists: ivf.SortedLists, offs, k: int,
                 metric, cap: int, post_filter, overfetch: int, l2_finish, halve: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Postlude of the fused scans: cross-probe top-k of the tile pool (plus
    the per-probe offsets ``offs``; None for the flat scan) by
    ``ops.pool_topk``, and global ids, recovered at the winners only from
    (window start, 128-slice, lane). ``post_filter`` (bitmap/udf) masks an
    ``overfetch``x deep pool before the final cut. ``halve`` halves the
    values first (the flat scan's bitset IP scores, -2 q.y); IP is negated;
    L2 values go through the scan's own ``l2_finish(values, finite mask)``
    (``_flat_l2``, ``_offsets_l2``)."""
    nq, p = pair_tile.shape
    ip = metric == DistanceType.InnerProduct
    Fc = cap * 128
    tracing.count("merge_rows", nq * p * Fc)
    kk = min(k, p * Fc)
    fetch = min(p * Fc, max(k * overfetch, k)) if post_filter is not None else kk
    tv, tl = ops_pool.pool_topk(out_v, pair_tile, pair_slot, offs, fetch)
    ok = torch.isfinite(tv)
    # pool column = probe j * Fc + rank r * 128 + lane; stored uint8 = slice.
    # A dropped pair's tile (n_tiles) is clamped: its entries read +inf, never ok.
    j, c = tl // Fc, tl % Fc
    tile = torch.gather(pair_tile, 1, j).long().clamp_max(out_v.shape[0] - 1)
    slot = torch.gather(pair_slot, 1, j).long()
    pos = al[tile] + out_i[tile, slot, c].long() * 128 + c % 128
    fi = torch.where(ok, lists.ids[torch.where(ok, pos, 0)], 0).to(torch.int32)

    if halve:
        tv = tv * 0.5
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
        fv = ivf.postprocess_distances(l2_finish(tv, ok), metric)
    if kk < k:
        fv = torch.nn.functional.pad(fv, (0, k - kk), value=float("-inf") if ip else float("inf"))
        fi = torch.nn.functional.pad(fi, (0, k - kk))
    return fv, fi


def _flat_l2(queries_f32):
    """The flat scan's L2 finish: its pool holds |y|^2 - 2 q.y, so |q|^2 is
    added and the sum clamped at 0."""
    return lambda tv, ok: torch.clamp_min(tv + (queries_f32 * queries_f32).sum(1)[:, None], 0.0)


def _offsets_l2(tv, ok):
    """The quantized scans' L2 finish: the offsets carry the query terms, and
    only finite entries are clamped at 0."""
    return torch.where(ok, torch.clamp_min(tv, 0.0), float("inf"))


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

    ip = metric == DistanceType.InnerProduct
    with tracing.span("ivf::group"):
        t = _fused_tiles(lists, probe_ids, codes_t.shape[1], window, m_tile, n_tiles, k, bin_cap,
                         prefilter)
        qrot, qrot_p, centers_tile, dp = _rotated_operands(queries_f32, rotation, centers_rot,
                                                           t.safe_c)
        cb_t = block_diag_codebook(pq_centers, dp)
        if t.bitset is not None:
            # IP scoring has no norm term: the norm channel carries a 0/+inf
            # filter penalty instead (the kernel's use_pen path)
            sorted_norms = _poisoned(t.bitset, lists, sorted_norms, zeros=ip)
    with tracing.span("ivf::scan"):
        out_v, out_i = ops_ivf_scan.fused_pq_scan(
            codes_t, sorted_norms, qrot_p, cb_t, centers_tile, t.qidx, t.al, t.lo, t.sizes,
            W=t.W, m_tile=m_tile, ip=ip, cap=t.cap, book=book,
            use_pen=ip and t.bitset is not None, int8_mode=fused_dtype == "int8",
            pq_len=pq_centers.shape[2])
    with tracing.span("ivf::merge"):
        # per-(query, probe) cluster term: L2 adds |Rq - c_rot|^2, IP -q.c
        offs = _cluster_offsets(qrot, centers_rot, probe_ids, ip)
        return _merge_pools(out_v, out_i, t.pair_tile, t.pair_slot, t.al, lists, offs, k, metric,
                            t.cap, t.post, overfetch, _offsets_l2)


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

    ip = metric == DistanceType.InnerProduct
    rot_dim = rotation.shape[0]
    book = 1 << bits
    with tracing.span("ivf::group"):
        t = _fused_tiles(lists, probe_ids, codes_t.shape[1], window, m_tile, n_tiles, k, bin_cap,
                         prefilter)
        qrot, qrot_p, centers_tile, dp = _rotated_operands(queries_f32, rotation, centers_rot,
                                                           t.safe_c)
        kb = -((1 << bits) - 1) / 2.0
        levels = torch.arange(book, dtype=torch.float32, device=qrot.device) + kb
        cb_t = block_diag_codebook(levels[None, :, None].expand(rot_dim, book, 1), dp)
        if t.bitset is not None:  # -(fa + fr*dots) is -inf on filtered rows whatever the metric
            sorted_fa = _poisoned(t.bitset, lists, sorted_fa, zeros=False)
    with tracing.span("ivf::scan"):
        out_v, out_i = ops_ivf_scan.fused_pq_scan(
            codes_t, sorted_fa, qrot_p, cb_t, centers_tile, t.qidx, t.al, t.lo, t.sizes, W=t.W,
            m_tile=m_tile, ip=ip, cap=t.cap, book=book, bits=bits, mode="rabitq",
            sorted_fr=sorted_fr, pq_len=1)
    with tracing.span("ivf::merge"):
        offs = _cluster_offsets(qrot, centers_rot, probe_ids, ip)
        return _merge_pools(out_v, out_i, t.pair_tile, t.pair_slot, t.al, lists, offs, k, metric,
                            t.cap, t.post, overfetch, _offsets_l2)


# ---------------------------------------------------------------------------
# unfused cluster-major scans: one batched product per chunk of lists/tiles
# ---------------------------------------------------------------------------

def _windows(lists: ivf.SortedLists, cl: torch.Tensor, window: int):
    """Per list (or tile; -1 = empty) of a chunk: the list id clamped into
    range and the window's ids, labels and start positions."""
    safe_c = torch.clamp(cl.long(), 0, lists.offsets.shape[0] - 1)
    starts = lists.offsets[safe_c]
    return (safe_c, starts, ivf.window_gather(lists.ids, starts, window),
            ivf.window_gather(lists.labels, starts, window))


def _masked(order, qi, safe_q, safe_c, ids_w, lab_w, prefilter):
    """+inf where a window row is not in the list, a slot is empty or the
    filter drops the (query, row) pair. order [C, M, W]."""
    valid = (lab_w == safe_c[:, None])[:, None, :] & (qi >= 0)[:, :, None]
    mask = filt.passes(prefilter, safe_q[:, :, None], ids_w[:, None, :])
    if mask is not None:
        valid = valid & mask
    return torch.where(valid, order, float("inf"))


def _row_topk(order, ids_w, kk: int, recall_target):
    """Per (list, slot) top-kk of order [C, M, W] -> (values, ids) [C, M, kk]."""
    C, M, W = order.shape
    tv, tl = topk(order.reshape(C * M, W), kk, True, recall_target)
    ti = torch.gather(ids_w[:, None, :].expand(C, M, W).reshape(C * M, W), 1, tl)
    return tv.reshape(C, M, -1), ti.reshape(C, M, -1)


def _flat_chunk(sorted_data, sorted_norms, lists, qi, cl, qc_all, qn, queries_f32, scale2,
                q_scale, metric, window, compute_dtype, prefilter, kk, recall_target):
    """Scores of one chunk of lists or tiles (qi [C, M] queries, cl [C]
    lists) against their windows, masked, and each slot's top-kk."""
    is_udf = callable(metric) and not isinstance(metric, DistanceType)
    safe_c, starts, ids_w, lab_w = _windows(lists, cl, window)
    data_w = ivf.window_gather(sorted_data, starts, window)  # [C, W, dp]
    norm_w = ivf.window_gather(sorted_norms, starts, window)
    safe_q = torch.clamp_min(qi.long(), 0)
    if is_udf:
        # fn(q [M, d], rows [W, d]) -> [M, W] per tile, vmapped over the chunk;
        # quantized rows are dequantized first
        d = queries_f32.shape[1]
        data_f = data_w[..., :d].float()
        if q_scale is not None:
            data_f = data_f * q_scale
        order = torch.func.vmap(metric)(queries_f32[safe_q], data_f).float()
    else:
        if scale2 is not None:  # int8 rows and queries: exact int32 dots
            dots = pairwise.int_dots(qc_all[safe_q], data_w).float() * scale2
        else:
            dots = torch.bmm(qc_all[safe_q].float(),
                             data_w.to(compute_dtype).float().transpose(1, 2))
        if metric == DistanceType.InnerProduct:
            order = -dots
        elif metric == DistanceType.CosineExpanded:
            order = 1.0 - dots / torch.clamp_min(qn[safe_q][:, :, None]
                                                 * torch.sqrt(norm_w)[:, None, :], 1e-30)
        else:
            order = torch.clamp_min(qn[safe_q][:, :, None] + norm_w[:, None, :] - 2.0 * dots, 0.0)
    order = _masked(order, qi, safe_q, safe_c, ids_w, lab_w, prefilter)
    return _row_topk(order, ids_w, kk, recall_target)


def _flat_operands(sorted_data, queries_f32, metric, compute_dtype, q_scale):
    """Queries padded to the stored width and cast (int8 with the index's
    scale), their norms (L2 for cosine) and the int8 rescale q_scale^2."""
    d = queries_f32.shape[1]
    dp = sorted_data.shape[1]
    qpad = torch.nn.functional.pad(queries_f32, (0, dp - d)) if dp != d else queries_f32
    qn = (queries_f32 * queries_f32).sum(1)
    if metric == DistanceType.CosineExpanded:
        qn = torch.sqrt(qn)
    if q_scale is not None:
        return torch.clamp(torch.round(qpad / q_scale), -127, 127).to(torch.int8), qn, \
            q_scale * q_scale
    return qpad.to(compute_dtype), qn, None


def _final_pool(tv, ti, rows, cols, k: int, metric):
    """Gather each pair's per-slot results (rows, cols [nq, p] index the
    [R, M, kk] results padded with one +inf row/column for dropped pairs),
    then the exact top-k over the [nq, p * kk] pool."""
    nq, p = rows.shape
    kk = tv.shape[2]
    tracing.count("merge_rows", nq * p * kk)
    pv = tv[rows.long(), cols.long()].reshape(nq, p * kk)
    pi = ti[rows.long(), cols.long()].reshape(nq, p * kk)
    fv, fl = topk(pv, k, True)
    fi = torch.gather(pi, 1, fl)
    if metric == DistanceType.InnerProduct:
        fv = -fv
    return ivf.postprocess_distances(fv, metric), fi


def cluster_major_scan(sorted_data, sorted_norms, lists: ivf.SortedLists, queries_f32, probe_ids,
                       prefilter, k: int, metric, window: int, max_per_cluster: int,
                       cluster_chunk: int, compute_dtype, recall_target=None, q_scale=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-Flat cluster-major search over ``max_per_cluster`` slots per list
    (size it with ``max_occupancy`` so no pair drops). Returns (dists
    [nq, k], ids [nq, k]). ``q_scale`` set: int8 rows and quantized queries,
    exact int32 dots rescaled by q_scale^2; norms stay exact f32."""
    n_lists = lists.offsets.shape[0]
    M = max_per_cluster
    with tracing.span("ivf::group"):
        qc_all, qn, scale2 = _flat_operands(sorted_data, queries_f32, metric, compute_dtype,
                                            q_scale)
        qidx, pair_slot = group_pairs(probe_ids, n_lists, M)
    kk = min(k, window)
    cl_ids = torch.arange(n_lists, device=queries_f32.device)
    with tracing.span("ivf::scan"):
        parts = [_flat_chunk(sorted_data, sorted_norms, lists, qidx[c0:c0 + cluster_chunk],
                             cl_ids[c0:c0 + cluster_chunk], qc_all, qn, queries_f32, scale2,
                             q_scale, metric, window, compute_dtype, prefilter, kk, recall_target)
                 for c0 in range(0, n_lists, cluster_chunk)]
    with tracing.span("ivf::merge"):
        # one extra slot column: dropped pairs (pair_slot == M) land there
        tv = torch.nn.functional.pad(torch.cat([v for v, _ in parts]), (0, 0, 0, 1),
                                     value=float("inf"))
        ti = torch.nn.functional.pad(torch.cat([i for _, i in parts]), (0, 0, 0, 1))
        return _final_pool(tv, ti, probe_ids, pair_slot, k, metric)


def cluster_major_scan_tiled(sorted_data, sorted_norms, lists: ivf.SortedLists, queries_f32,
                             probe_ids, prefilter, k: int, metric, window: int, m_tile: int,
                             cluster_chunk: int, compute_dtype, recall_target, n_tiles: int,
                             q_scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-Flat cluster-major search over fixed-width pair tiles
    (``group_pairs_tiled``): each chunk of ``cluster_chunk`` tiles is one
    batched product [C, M, dp] x [C, W, dp] -> [C, M, W], masked, and each
    slot keeps its top-k. L2, IP, cosine and metric UDFs: a UDF
    ``fn(q [M, d], rows [W, d]) -> [M, W]`` is called per tile through
    ``torch.func.vmap`` over the chunk's tiles, so a UDF that broadcasts
    builds [C, M, W, d] at once: ``ivf_flat.search`` sizes ``cluster_chunk``
    for that block. ``q_scale`` set: int8 rows."""
    n_lists = lists.offsets.shape[0]
    with tracing.span("ivf::group"):
        qc_all, qn, scale2 = _flat_operands(sorted_data, queries_f32, metric, compute_dtype,
                                            q_scale)
        tile_cluster, qidx, pair_tile, pair_slot = group_pairs_tiled(probe_ids, n_lists, m_tile,
                                                                     n_tiles)
    kk = min(k, window)
    with tracing.span("ivf::scan"):
        parts = [_flat_chunk(sorted_data, sorted_norms, lists, qidx[t0:t0 + cluster_chunk],
                             tile_cluster[t0:t0 + cluster_chunk], qc_all, qn, queries_f32, scale2,
                             q_scale, metric, window, compute_dtype, prefilter, kk, recall_target)
                 for t0 in range(0, n_tiles, cluster_chunk)]
    with tracing.span("ivf::merge"):
        # one extra tile row: dropped pairs (pair_tile == n_tiles) land there
        tv = torch.nn.functional.pad(torch.cat([v for v, _ in parts]), (0, 0, 0, 0, 0, 1),
                                     value=float("inf"))
        ti = torch.nn.functional.pad(torch.cat([i for _, i in parts]), (0, 0, 0, 0, 0, 1))
        return _final_pool(tv, ti, pair_tile, pair_slot, k, metric)


def _bin_rounds(order, ids_w, cap: int):
    """``cap`` masked-max rounds over the 128-position bins of each slot's
    window (the fused kernels' selection): round r keeps each bin's best
    remaining entry, first index at ties. Returns (values, ids) [C, M,
    cap * F], column round * F + bin."""
    C, M, W = order.shape
    F = W // 128
    neg = (-order).reshape(C * M, F, 128)
    fbase = torch.arange(F, device=order.device)[None, :] * 128
    ids_b = ids_w[:, None, :].expand(C, M, W).reshape(C * M, W)
    vs, is_ = [], []
    for r in range(cap):
        mv, am = torch.max(neg, dim=2)
        vs.append(-mv)
        is_.append(torch.gather(ids_b, 1, fbase + am))
        if r + 1 < cap:
            neg = neg.scatter(2, am[:, :, None], float("-inf"))
    return torch.cat(vs, 1).reshape(C, M, -1), torch.cat(is_, 1).reshape(C, M, -1)


def cluster_major_scan_pq(sorted_codes, centers, centers_rot, pq_centers, rotation,
                          lists: ivf.SortedLists, queries_f32, probe_ids, prefilter, k: int, metric,
                          window: int, max_per_cluster: int, cluster_chunk: int, compute_dtype,
                          recall_target=None, pq_bits: int = 8, codebook_gen: str = "per_subspace",
                          pq_dim_s: int = 0, bin_cap: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ cluster-major search by decode-and-dot: each list's window is
    reconstructed once in the rotated space (``centers_rot[c] + codebook[s,
    code]``; per-cluster codebooks ``pq_centers[c]``) and scored against the
    list's queries by one batched product, which ranks as the ADC table does
    for L2 and IP. ``bin_cap > 0`` selects per window by ``bin_cap``
    masked-max rounds over 128-position bins (``_bin_rounds``) instead of an
    exact per-slot top-k; PQ candidates feed refine() anyway."""
    n_lists = lists.offsets.shape[0]
    M = max_per_cluster
    per_cluster = codebook_gen == "per_cluster"
    if per_cluster:
        pq_dim = pq_dim_s
        _, book, pq_len = pq_centers.shape
    else:
        pq_dim, book, pq_len = pq_centers.shape
    rot_dim = pq_dim * pq_len
    dev = queries_f32.device
    with tracing.span("ivf::group"):
        qidx, pair_slot = group_pairs(probe_ids, n_lists, M)
        qrot = (queries_f32 @ rotation.T).to(compute_dtype)
        qn = (queries_f32 * queries_f32).sum(1)
    F = window // 128
    kk = min(bin_cap, 128) * F if bin_cap else min(k, window)
    sub_ids = torch.arange(pq_dim, device=dev)
    cl_ids = torch.arange(n_lists, device=dev)
    with tracing.span("ivf::scan"):
        parts = []
        for c0 in range(0, n_lists, cluster_chunk):
            qi = qidx[c0:c0 + cluster_chunk]
            safe_c, starts, ids_w, lab_w = _windows(lists, cl_ids[c0:c0 + cluster_chunk], window)
            C = qi.shape[0]
            words_w = ivf.window_gather(sorted_codes, starts, window)  # [C, W, words]
            codes_w = bitpack.unpack(words_w, pq_bits, pq_dim).long()  # [C, W, S]
            if per_cluster:
                recon = pq_centers[safe_c][torch.arange(C, device=dev)[:, None, None], codes_w]
            else:
                recon = pq_centers[sub_ids[None, None, :], codes_w]  # [C, W, S, pq_len]
            y = recon.reshape(C, window, rot_dim) + centers_rot[safe_c][:, None, :]
            yn = (y * y).sum(2)
            safe_q = torch.clamp_min(qi.long(), 0)
            dots = torch.bmm(qrot[safe_q].float(), y.to(compute_dtype).float().transpose(1, 2))
            if metric == DistanceType.InnerProduct:
                order = -dots
            else:
                order = torch.clamp_min(qn[safe_q][:, :, None] + yn[:, None, :] - 2.0 * dots, 0.0)
            order = _masked(order, qi, safe_q, safe_c, ids_w, lab_w, prefilter)
            if bin_cap:
                parts.append(_bin_rounds(order, ids_w, min(bin_cap, 128)))
            else:
                parts.append(_row_topk(order, ids_w, kk, recall_target))
    with tracing.span("ivf::merge"):
        tv = torch.nn.functional.pad(torch.cat([v for v, _ in parts]), (0, 0, 0, 1),
                                     value=float("inf"))
        ti = torch.nn.functional.pad(torch.cat([i for _, i in parts]), (0, 0, 0, 1))
        return _final_pool(tv, ti, probe_ids, pair_slot, k, metric)
