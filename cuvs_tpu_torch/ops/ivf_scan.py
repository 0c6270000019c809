"""Fused IVF cluster-major scan — port of ``cuvs_tpu.ops.ivf_scan_pallas.fused_ivf_scan``.

One hand-written CUDA kernel (``csrc/ivf_scan.cu``) scores each pair tile of
``group_pairs_tiled`` (M query slots probing one list) against its list's
window of sorted rows and keeps the best ``cap`` rows per strided lane bin,
so no [tiles, M, W] score tensor reaches device memory. ``fused_ivf_scan``
launches it for CUDA tensors (or raises); ``fused_ivf_scan_reference`` is the
plain PyTorch version with the same output contract, which the wrapper runs
for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuvs_tpu_torch.distance.pairwise import int_dots
from cuvs_tpu_torch.ops import _lib

# Kernel launches since the last reset (see ops.bf_topk.LAUNCHES).
LAUNCHES = {"ivf_scan": 0}

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
    q = _queries_padded(queries, dp, sorted_data.dtype)
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
    blocks = W // 128
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
        v = (dots - pen[:, None, :]).reshape(t1 - t0, M, blocks, 128)
        best = [torch.full((t1 - t0, M, 128), float("-inf"), device=dev) for _ in range(cap)]
        bidx = [torch.zeros((t1 - t0, M, 128), dtype=torch.int32, device=dev) for _ in range(cap)]
        for cc in range(blocks):
            v_in = v[:, :, cc]
            i_in = torch.full_like(bidx[0], cc)
            # the reference's insertion chain: strict >, the displaced entry
            # moves one level down, the last level drops it
            for r in range(cap):
                tk = v_in > best[r]
                best[r], v_in = torch.where(tk, v_in, best[r]), torch.where(tk, best[r], v_in)
                bidx[r], i_in = torch.where(tk, i_in, bidx[r]), torch.where(tk, bidx[r], i_in)
        out_v[t0:t1] = f * torch.cat(best, dim=-1)
        out_i[t0:t1] = torch.cat(bidx, dim=-1).to(torch.uint8)
    return out_v, out_i
