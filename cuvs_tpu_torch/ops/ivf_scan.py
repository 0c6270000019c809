"""Fused IVF cluster-major scans — port of ``cuvs_tpu.ops.ivf_scan_pallas``.

Two hand-written CUDA kernels score each pair tile of ``group_pairs_tiled``
(M query slots probing one list) against its list's window and keep the best
``cap`` rows per strided lane bin, so no [tiles, M, W] score tensor reaches
device memory: ``fused_ivf_scan`` (``csrc/ivf_scan.cu``; f32 rows in
``csrc/ivf_scan_fma.cu``; bins deeper than 2, cap 3-32, in
``csrc/ivf_scan_deep.cu`` and ``ivf_scan_deep32.cu``) over raw rows
(IVF-Flat), ``fused_pq_scan`` (``csrc/pq_scan.cu``; bins deeper than 2 in
``csrc/pq_scan_deep.cu``; IVF-PQ's byte codes with a book of 16-128, and
IVF-RaBitQ at 1, 2 and 4-8 bits with its entries formed in registers, in
``csrc/pq_scan_widths.cu``) over packed quantized
codes through a per-slot lookup table (IVF-PQ and IVF-RaBitQ). Each wrapper launches its kernel for CUDA tensors (or raises)
and runs its plain PyTorch version, ``*_reference`` with the same output
contract, for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from cuvs_tpu_torch.core import bitpack
from cuvs_tpu_torch.distance.pairwise import int_dots
from cuvs_tpu_torch.ops import _lib

# Kernel launches since the last reset (see ops.bf_topk.LAUNCHES).
LAUNCHES = {"ivf_scan": 0, "pq_scan": 0}

_MAX_CAP = 32
# bound on the plain version's [tiles, M, W] score block, in elements
_REF_BLOCK = 1 << 26


def _queries_padded(queries: torch.Tensor, dp: int, row_dtype) -> torch.Tensor:
    """Queries padded to the rows' width. float32 and bfloat16 queries and
    rows mix (products in f32, as the reference's promotion does); int8 pairs
    only with int8."""
    if queries.dtype not in _lib.DTYPE_CODE or \
            (queries.dtype == torch.int8) != (row_dtype == torch.int8):
        raise TypeError(f"queries are {queries.dtype}, sorted rows are {row_dtype}")
    if queries.shape[1] != dp:
        queries = torch.nn.functional.pad(queries, (0, dp - queries.shape[1]))
    return queries.contiguous()


def fused_ivf_scan(sorted_data, sorted_norms, queries, qidx, starts_al, lo, sizes, scale2,
                   W: int, m_tile: int, ip: bool, int8_mode: bool, cap: int = 2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fused scan.

    sorted_data [n_pad, dp] (int8/bf16/f32) rows grouped by list;
    sorted_norms [>= n_pad] f32 squared norms of the original rows; queries
    [nq, d] int8 (pre-quantized) for int8 rows, else float32 or bfloat16;
    qidx [n_tiles, M] int32 query per slot (-1 empty); starts_al, lo, sizes [n_tiles] int32: window
    start (row), first valid window position, list size (0 = empty tile);
    scale2 the dots scale (q_scale**2 for int8, else 1.0). Window position p
    of tile t is row starts_al[t] + p, p < W.

    Returns (order values [n_tiles, M, cap*128] f32, in-bin 128-slice ids
    [n_tiles, M, cap*128] uint8). Column r*128 + l holds the (r+1)-th best row
    of lane bin l (window positions l, l+128, ...), at window position
    slice*128 + l. Order values are ranking-space at true scale
    (L2: |y|^2 - 2 q.y; IP: -q.y); empty entries are +inf.
    """
    if not sorted_data.is_cuda:
        return fused_ivf_scan_reference(sorted_data, sorted_norms, queries, qidx, starts_al,
                                        lo, sizes, scale2, W, m_tile, ip, int8_mode, cap)
    dev = sorted_data.device
    n_tiles, M = qidx.shape
    n_rows, dp = sorted_data.shape
    if sorted_data.dtype not in _lib.DTYPE_CODE or int8_mode != (sorted_data.dtype == torch.int8):
        raise TypeError(f"unsupported sorted_data dtype {sorted_data.dtype}")
    if not 1 <= cap <= _MAX_CAP or W % 128 or W // 128 > 256:
        raise ValueError(f"need 1 <= cap <= {_MAX_CAP} and W a multiple of 128 <= 32768")
    if not sorted_data.is_contiguous():
        raise ValueError("sorted_data must be contiguous")
    if queries.device != dev:
        raise ValueError(f"queries are on {queries.device}, sorted_data on {dev}")
    q = _queries_padded(queries, dp, sorted_data.dtype)
    if sorted_data.dtype == torch.float32:
        q = q.float()  # the fp32 tile takes f32 queries; widening bf16 is exact
    norms = sorted_norms.to(device=dev, dtype=torch.float32).contiguous()
    if norms.shape[0] < n_rows:
        raise ValueError("sorted_norms is shorter than sorted_data")
    qidx = qidx.to(device=dev, dtype=torch.int32).contiguous()
    al = starts_al.to(device=dev, dtype=torch.int32).contiguous()
    lo = lo.to(device=dev, dtype=torch.int32).contiguous()
    sizes = sizes.to(device=dev, dtype=torch.int32).contiguous()
    if al.shape != (n_tiles,) or lo.shape != (n_tiles,) or sizes.shape != (n_tiles,):
        raise ValueError("starts_al, lo and sizes must be [n_tiles]")
    scale = torch.as_tensor(scale2, dtype=torch.float32).to(dev).reshape(1).contiguous()
    F = cap * 128
    out_v = torch.empty((n_tiles, M, F), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_tiles, M, F), dtype=torch.uint8, device=dev)
    if n_tiles == 0 or M == 0:
        return out_v, out_i
    rc = _lib.lib().cuvs_ivf_scan(
        _lib.DTYPE_CODE[sorted_data.dtype], _lib.DTYPE_CODE[q.dtype], sorted_data.data_ptr(),
        norms.data_ptr(), q.data_ptr(), qidx.data_ptr(), al.data_ptr(), lo.data_ptr(), sizes.data_ptr(), scale.data_ptr(),
        n_tiles, M, dp, n_rows, int(W), int(cap), int(bool(ip)), out_v.data_ptr(),
        out_i.data_ptr(), _lib.stream(dev))
    _lib.check(rc, "ivf_scan")
    LAUNCHES["ivf_scan"] += 1
    return out_v, out_i


def _window_dots(qrows: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Batched [T, M, dp] x [T, W, dp] -> [T, M, W] float32 dots (exact for int8)."""
    if qrows.dtype == torch.int8:
        return int_dots(qrows, rows).float()
    return torch.bmm(qrows.float(), rows.float().transpose(1, 2))


def fused_ivf_scan_reference(sorted_data, sorted_norms, queries, qidx, starts_al, lo, sizes,
                             scale2, W: int, m_tile: int, ip: bool, int8_mode: bool,
                             cap: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``fused_ivf_scan`` (same contract)."""
    dev = sorted_data.device
    n_tiles, M = qidx.shape
    n_rows, dp = sorted_data.shape
    q = _queries_padded(queries, dp, sorted_data.dtype)
    norms = sorted_norms.to(device=dev, dtype=torch.float32)
    qidx = qidx.to(device=dev, dtype=torch.int64)
    al = starts_al.to(device=dev, dtype=torch.int64)
    lo = lo.to(device=dev, dtype=torch.int64)
    hi = lo + sizes.to(device=dev, dtype=torch.int64)
    scale = torch.as_tensor(scale2, dtype=torch.float32).to(dev)
    half_inv = 0.5 / scale
    f = -scale if ip else -2.0 * scale
    pos = torch.arange(W, device=dev)
    out_v = torch.empty((n_tiles, M, cap * 128), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_tiles, M, cap * 128), dtype=torch.uint8, device=dev)
    step = max(1, _REF_BLOCK // max(1, M * W))
    for t0 in range(0, n_tiles, step):
        t1 = min(n_tiles, t0 + step)
        qi = qidx[t0:t1]
        qrows = torch.where((qi >= 0)[..., None], q[qi.clamp_min(0)],
                            torch.zeros((), dtype=q.dtype, device=dev))
        rows = al[t0:t1, None] + pos[None, :]
        in_rows = (rows >= 0) & (rows < n_rows)
        data_w = torch.where(in_rows[..., None], sorted_data[rows.clamp(0, n_rows - 1)],
                             torch.zeros((), dtype=sorted_data.dtype, device=dev))
        dots = _window_dots(qrows, data_w)
        valid = (pos[None, :] >= lo[t0:t1, None]) & (pos[None, :] < hi[t0:t1, None])
        if ip:
            pen = torch.where(valid, 0.0, float("inf"))
        else:
            nrm = norms[rows.clamp(0, norms.shape[0] - 1)]
            pen = torch.where(valid, nrm * half_inv, float("inf"))
        best, bidx = _bin_insert(dots - pen[:, None, :], cap)
        out_v[t0:t1] = f * best
        out_i[t0:t1] = bidx
    return out_v, out_i


def _bin_insert(v: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernels' bin reduction of scores v [T, M, W] (W a multiple of
    128): lane bin l collects window positions l, l+128, ..., taken slice by
    slice, and keeps its best ``cap`` by the insertion chain (strict >, the
    displaced entry moves one level down, the last level drops it). Returns
    (best [T, M, cap*128] f32, slice ids [T, M, cap*128] uint8)."""
    T, M, W = v.shape
    v = v.reshape(T, M, W // 128, 128)
    best = [torch.full((T, M, 128), float("-inf"), device=v.device) for _ in range(cap)]
    bidx = [torch.zeros((T, M, 128), dtype=torch.int32, device=v.device) for _ in range(cap)]
    for cc in range(W // 128):
        v_in = v[:, :, cc]
        i_in = torch.full_like(bidx[0], cc)
        for r in range(cap):
            tk = v_in > best[r]
            best[r], v_in = torch.where(tk, v_in, best[r]), torch.where(tk, best[r], v_in)
            bidx[r], i_in = torch.where(tk, i_in, bidx[r]), torch.where(tk, bidx[r], i_in)
    return torch.cat(best, dim=-1), torch.cat(bidx, dim=-1).to(torch.uint8)


_PQ_MODES = ("pq", "rabitq")
_PQ_SHARES = 4  # threads that share a window row in the kernel, each summing its codes


def _pq_operands(codes_t, queries_rot, cb_t, centers_tile, qidx, book, bits, mode, sorted_fr,
                 W, cap, pq_len):
    """Check the fused PQ scan's operands; returns (int32 words, S)."""
    if mode not in _PQ_MODES:
        raise ValueError(f"mode must be one of {_PQ_MODES}")
    if mode == "rabitq" and sorted_fr is None:
        raise ValueError("mode 'rabitq' needs sorted_fr")
    for name, t in (("queries_rot", queries_rot), ("cb_t", cb_t), ("centers_tile", centers_tile)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    words = codes_t.view(torch.int32) if codes_t.dtype == torch.uint32 else codes_t
    if words.dtype != torch.int32 or words.ndim != 2:
        raise TypeError("codes_t must be [Sw, n_pad] 32-bit words (int32 bit patterns or uint32)")
    dp = queries_rot.shape[1]
    S = cb_t.shape[1] // book
    n_tiles = qidx.shape[0]
    if cb_t.shape != (dp, S * book) or S < 1:
        raise ValueError(f"cb_t must be [dp, S*book], got {tuple(cb_t.shape)} for book {book}")
    if centers_tile.shape != (n_tiles, dp):
        raise ValueError("centers_tile must be [n_tiles, dp]")
    if not 1 <= bits <= 32 or words.shape[0] < bitpack.packed_words(S, bits):
        raise ValueError(f"{S} codes of {bits} bits need {bitpack.packed_words(S, bits)} word rows")
    if not 1 <= cap <= _MAX_CAP or W % 128 or W // 128 > 256:
        raise ValueError(f"need 1 <= cap <= {_MAX_CAP} and W a multiple of 128 <= 32768")
    if pq_len < 1:
        raise ValueError(f"pq_len must be >= 1, got {pq_len}")
    return words, S


def fused_pq_scan(codes_t, sorted_norms, queries_rot, cb_t, centers_tile, qidx, starts_al, lo,
                  sizes, W: int, m_tile: int, ip: bool, cap: int = 2, book: int = 256,
                  bits: int = 8, mode: str = "pq", sorted_fr=None, use_pen: bool = False,
                  int8_mode: bool = False, *, pq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fused quantized-code scan.

    codes_t [Sw, n_pad] packed 32-bit words (int32 bit patterns, or uint32):
    code s of sorted row r is bits [s*bits, (s+1)*bits) of column r; only the
    first ceil(S*bits/32) word rows are read. sorted_norms [>= n] f32, read by
    row: "pq" the decoded residuals' squared norms (IP with ``use_pen``: a
    0/+inf filter penalty), "rabitq" the estimator's f_add; sorted_fr: the
    rabitq f_rescale. queries_rot [nq, dp], cb_t [dp, S*book] (transposed
    block-diagonal codebook) and centers_tile [n_tiles, dp] are bfloat16;
    qidx, starts_al, lo, sizes as in ``fused_ivf_scan``. ``pq_len`` is the
    height of cb_t's diagonal blocks: column s*book + c is nonzero only on
    rows [s*pq_len, (s+1)*pq_len), and the table reads only those rows.
    ``int8_mode`` quantizes the table to int8 with one scale per tile,
    max |lut| over all its slots / 127. For CUDA codes, queries_rot, cb_t and
    centers_tile must lie on the same device.

    Returns (order values [n_tiles, M, cap*128] f32, in-bin 128-slice ids
    uint8), the layout of ``fused_ivf_scan``: "pq" |y|^2 - 2 q'.y (L2) or
    -q'.y (IP), "rabitq" fa + fr*<q_rot, xu>; the caller adds the per-probe
    cluster term. Empty entries are +inf.
    """
    if not codes_t.is_cuda:
        return fused_pq_scan_reference(codes_t, sorted_norms, queries_rot, cb_t, centers_tile,
                                       qidx, starts_al, lo, sizes, W, m_tile, ip, cap, book,
                                       bits, mode, sorted_fr, use_pen, int8_mode,
                                       pq_len=pq_len)
    dev = codes_t.device
    words, S = _pq_operands(codes_t, queries_rot, cb_t, centers_tile, qidx, book, bits, mode,
                            sorted_fr, W, cap, pq_len)
    for name, t in (("queries_rot", queries_rot), ("cb_t", cb_t), ("centers_tile", centers_tile)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, codes_t on {dev}")
    n_tiles, M = qidx.shape
    dp = queries_rot.shape[1]
    rabitq = mode == "rabitq"
    words = words.contiguous()
    q = queries_rot.contiguous()
    cb = cb_t.contiguous()
    ct = centers_tile.contiguous()
    norms = sorted_norms.to(device=dev, dtype=torch.float32).contiguous()
    n_norms = norms.shape[0]
    fr = None
    if rabitq:
        fr = sorted_fr.to(device=dev, dtype=torch.float32).contiguous()
        n_norms = min(n_norms, fr.shape[0])
    qidx = qidx.to(device=dev, dtype=torch.int32).contiguous()
    al = starts_al.to(device=dev, dtype=torch.int32).contiguous()
    lo = lo.to(device=dev, dtype=torch.int32).contiguous()
    sizes = sizes.to(device=dev, dtype=torch.int32).contiguous()
    if al.shape != (n_tiles,) or lo.shape != (n_tiles,) or sizes.shape != (n_tiles,):
        raise ValueError("starts_al, lo and sizes must be [n_tiles]")
    F = cap * 128
    out_v = torch.empty((n_tiles, M, F), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_tiles, M, F), dtype=torch.uint8, device=dev)
    if n_tiles == 0 or M == 0:
        return out_v, out_i
    absmax = torch.zeros((n_tiles,), dtype=torch.float32, device=dev)
    rc = _lib.lib().cuvs_pq_scan(
        words.data_ptr(), words.shape[0], words.shape[1], norms.data_ptr(), n_norms,
        fr.data_ptr() if rabitq else None, q.data_ptr(), cb.data_ptr(), ct.data_ptr(),
        qidx.data_ptr(), al.data_ptr(), lo.data_ptr(), sizes.data_ptr(), n_tiles, M, dp, S,
        int(book), int(bits), int(pq_len), int(W), int(cap), int(rabitq), int(bool(ip)),
        int(bool(use_pen)), int(bool(int8_mode)), absmax.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), _lib.stream(dev))
    _lib.check(rc, f"pq_scan (one slot's {S} x {book} lookup table must fit shared memory)")
    LAUNCHES["pq_scan"] += 1
    return out_v, out_i


def _compact_codebook(cb_t: torch.Tensor, S: int, book: int, pq_len: int):
    """The nonzero blocks of cb_t as [S, pq_len, book] f32 with their row ids
    [S, pq_len]."""
    dp = cb_t.shape[0]
    cbv = cb_t.float().reshape(dp, S, book)
    rows = (torch.arange(S, device=cb_t.device)[:, None] * pq_len
            + torch.arange(pq_len, device=cb_t.device)[None, :])
    ok = rows < dp
    rows = rows.clamp_max(dp - 1)
    blocks = cbv[rows, torch.arange(S, device=cb_t.device)[:, None], :]  # [S, L, book]
    return torch.where(ok[..., None], blocks, 0.0), rows


def fused_pq_scan_reference(codes_t, sorted_norms, queries_rot, cb_t, centers_tile, qidx,
                            starts_al, lo, sizes, W: int, m_tile: int, ip: bool, cap: int = 2,
                            book: int = 256, bits: int = 8, mode: str = "pq", sorted_fr=None,
                            use_pen: bool = False, int8_mode: bool = False, *, pq_len: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``fused_pq_scan`` (same contract). Sums in
    the kernel's order: each table entry over its rows in order; each score
    in four shares, share j the codes of periods j, j + 4, ... in code order
    (a period: the fewest codes that fill whole 32-bit words), then the
    shares in order j = 0..3."""
    dev = codes_t.device
    words, S = _pq_operands(codes_t, queries_rot, cb_t, centers_tile, qidx, book, bits, mode,
                            sorted_fr, W, cap, pq_len)
    n_tiles, M = qidx.shape
    n_pad = words.shape[1]
    rabitq = mode == "rabitq"
    cbc, rows_sl = _compact_codebook(cb_t, S, book, pq_len)
    q = queries_rot.to(dev)
    ct = centers_tile.to(dev)
    norms = sorted_norms.to(device=dev, dtype=torch.float32)
    fr_all = sorted_fr.to(device=dev, dtype=torch.float32) if rabitq else None
    qidx = qidx.to(device=dev, dtype=torch.int64)
    al = starts_al.to(device=dev, dtype=torch.int64)
    lo = lo.to(device=dev, dtype=torch.int64)
    hi = lo + sizes.to(device=dev, dtype=torch.int64)
    f = -1.0 if (ip or rabitq) else -2.0
    period = 32 // math.gcd(32, bits)
    pos = torch.arange(W, device=dev)
    out_v = torch.empty((n_tiles, M, cap * 128), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_tiles, M, cap * 128), dtype=torch.uint8, device=dev)
    step = max(1, min(_REF_BLOCK // max(1, M * W), _REF_BLOCK // max(1, M * S * book)))
    for t0 in range(0, n_tiles, step):
        t1 = min(n_tiles, t0 + step)
        T = t1 - t0
        qi = qidx[t0:t1]
        qrows = torch.where((qi >= 0)[..., None], q[qi.clamp_min(0)],
                            torch.zeros((), dtype=q.dtype, device=dev))
        if not rabitq and not ip:
            qrows = qrows - ct[t0:t1, None, :]  # bf16 - bf16, rounded to bf16
        qs = qrows.float()[:, :, rows_sl]  # [T, M, S, L]
        lut = torch.zeros((T, M, S, book), device=dev)
        for l in range(cbc.shape[1]):
            lut = lut + qs[..., l, None] * cbc[:, l, :]
        if int8_mode:
            # a tensor divisor: PyTorch's CUDA division by a Python scalar
            # multiplies by its reciprocal, which rounds otherwise than the
            # kernel's IEEE division
            absmax = torch.clamp_min(lut.abs().amax(dim=(1, 2, 3)), 1e-30)
            ls = absmax / torch.tensor(127.0, device=dev)
            lut = torch.round(lut / ls[:, None, None, None]).to(torch.int32)
        else:
            lut = lut.to(torch.bfloat16).float()
        # codes of the window's rows [T, W, S]
        rows = al[t0:t1, None] + pos[None, :]
        rw = words[:, rows.clamp(0, n_pad - 1)].permute(1, 2, 0)
        codes = bitpack.unpack(rw, bits, S).long()
        in_book = codes < book
        codes = codes.clamp_max(book - 1)
        shares = [torch.zeros((T, M, W), dtype=lut.dtype, device=dev) for _ in range(_PQ_SHARES)]
        for s in range(S):
            part = torch.gather(lut[:, :, s, :], 2, codes[:, None, :, s].expand(T, M, W))
            j = s // period % _PQ_SHARES
            shares[j] = shares[j] + torch.where(in_book[:, None, :, s], part, 0)
        dots = shares[0]
        for share in shares[1:]:
            dots = dots + share
        dots = dots.float() * ls[:, None, None] if int8_mode else dots
        valid = (pos[None, :] >= lo[t0:t1, None]) & (pos[None, :] < hi[t0:t1, None])
        nrm = torch.where(rows < norms.shape[0], norms[rows.clamp(0, norms.shape[0] - 1)], 0.0)
        if rabitq:
            fr = torch.where(rows < fr_all.shape[0], fr_all[rows.clamp(0, fr_all.shape[0] - 1)],
                             0.0)
            fa = torch.where(valid, nrm, float("inf"))
            v = -(fa[:, None, :] + fr[:, None, :] * dots)
        else:
            if ip:
                pen = torch.where(valid, nrm if use_pen else 0.0, float("inf"))
            else:
                pen = torch.where(valid, nrm * 0.5, float("inf"))
            v = dots - pen[:, None, :]
        best, bidx = _bin_insert(v, cap)
        out_v[t0:t1] = f * best
        out_i[t0:t1] = bidx
    return out_v, out_i
