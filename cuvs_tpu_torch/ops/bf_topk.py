"""Fused brute-force distance + top-k — port of ``cuvs_tpu.ops.bf_topk_pallas``.

Two hand-written CUDA kernels (``csrc/bf_topk.cu``) keep each [B, tile]
distance block on chip and write only a small candidate pool:

  * ``bf_topk_exact`` (exact=True): per (dataset tile, query) the exact top-k
    by (distance, column), pool [n_tiles, B, k]. It backs ground truth, so
    float32 inputs are multiplied in IEEE fp32 (no TF32).
  * ``bf_topk_approx`` (exact=False): per (tile, query, lane bin) the best
    ranking score over the tile's strided 128-column slices, pool
    [n_tiles, B, 128] of min-space values plus the uint8 slice. float32,
    bfloat16 and int8 (int32 arithmetic, both of the reference's branches:
    key-pack for d <= 130 and the compare/select chain above).

Each kernel has a plain PyTorch version (``*_reference``) with the same
output contract. A wrapper runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel, or raises.

The pools, their layouts and the host-side decode are the reference's, so the
port's results match the reference element for element. The approximate f32
path scores in exact fp32 where the TPU kernel used one bf16 MXU pass.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType, int_dots, row_norms
from cuvs_tpu_torch.ops import _lib
from cuvs_tpu_torch.selection.select_k import topk as _select_topk

# Kernel launches since the last reset; incremented only where a kernel is
# launched, so a run can show that its main path went through the kernels.
LAUNCHES = {"bf_topk_exact": 0, "bf_topk_approx": 0}

_MAX_EXACT_K = 64
# query rows per step of the plain versions: bounds their [rows, N] blocks
_REF_ROWS = 256


def _check_operands(queries: torch.Tensor, dataset: torch.Tensor) -> None:
    if queries.dtype not in _lib.DTYPE_CODE or dataset.dtype != queries.dtype:
        raise TypeError(f"queries/dataset must share float32, bfloat16 or int8, got "
                        f"{queries.dtype}/{dataset.dtype}")
    if queries.ndim != 2 or dataset.ndim != 2 or queries.shape[1] != dataset.shape[1]:
        raise ValueError(f"bad shapes {tuple(queries.shape)} vs {tuple(dataset.shape)}")
    if not (queries.is_contiguous() and dataset.is_contiguous()):
        raise ValueError("queries and dataset must be contiguous")
    if queries.device != dataset.device:
        raise ValueError("queries and dataset must be on one device")


def _dots(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain q @ x.T: exact int32 for int8, float32 otherwise."""
    if q.dtype == torch.int8:
        return int_dots(q, x)
    return q.float() @ x.float().T


# ---------------------------------------------------------------------------
# Kernel 1: exact per-tile top-k
# ---------------------------------------------------------------------------

def bf_topk_exact(queries, dataset, qn, dn, k: int, tile_n: int, ip: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile exact top-k pool.

    queries [B, d] and dataset [N, d] in one dtype; qn [B] and dn [N] their
    float32 squared norms (unused for IP). Distances are
    max(qn + dn - 2 q.x, 0) (L2) or -q.x (IP); padded columns are +inf.
    Returns (values [n_tiles, B, k] f32 ascending, global ids [n_tiles, B, k]
    int32), ties to the lowest column; a slot with no finite candidate holds
    +inf and the tile's first column.
    """
    if not queries.is_cuda:
        return bf_topk_exact_reference(queries, dataset, qn, dn, k, tile_n, ip)
    _check_operands(queries, dataset)
    B, d = queries.shape
    N = dataset.shape[0]
    if not 1 <= k <= _MAX_EXACT_K:
        raise ValueError(f"exact kernel takes 1 <= k <= {_MAX_EXACT_K}, got {k}")
    qn = qn.to(device=queries.device, dtype=torch.float32).contiguous()
    dn = dn.to(device=queries.device, dtype=torch.float32).contiguous()
    if qn.shape != (B,) or dn.shape != (N,):
        raise ValueError("qn/dn must be [B] and [N]")
    n_tiles = -(-N // tile_n)
    out_v = torch.empty((n_tiles, B, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((n_tiles, B, k), dtype=torch.int32, device=queries.device)
    if B == 0 or n_tiles == 0:
        return out_v, out_i
    rc = _lib.lib().cuvs_bf_topk_exact(
        _lib.DTYPE_CODE[queries.dtype], queries.data_ptr(), dataset.data_ptr(), qn.data_ptr(),
        dn.data_ptr(), B, N, d, int(k), int(tile_n), n_tiles, int(bool(ip)), out_v.data_ptr(),
        out_i.data_ptr(), _lib.stream(queries.device))
    _lib.check(rc, "bf_topk_exact")
    LAUNCHES["bf_topk_exact"] += 1
    return out_v, out_i


def bf_topk_exact_reference(queries, dataset, qn, dn, k: int, tile_n: int, ip: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``bf_topk_exact`` (same contract)."""
    B = queries.shape[0]
    N = dataset.shape[0]
    n_tiles = -(-N // tile_n)
    n_pad = n_tiles * tile_n
    kk = min(k, tile_n)
    dev = queries.device
    base = torch.arange(n_tiles, device=dev, dtype=torch.int64) * tile_n
    out_v = torch.full((n_tiles, B, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = base.to(torch.int32).view(n_tiles, 1, 1).expand(n_tiles, B, k).clone()
    qn = qn.float()
    dn = dn.float()
    for r0 in range(0, B, _REF_ROWS):
        q = queries[r0:r0 + _REF_ROWS]
        dots = _dots(q, dataset).float()
        if ip:
            dist = -dots
        else:
            dist = torch.clamp_min((qn[r0:r0 + q.shape[0], None] + dn[None, :]) - 2.0 * dots, 0.0)
        dist = torch.nn.functional.pad(dist, (0, n_pad - N), value=float("inf"))
        v, i = torch.sort(dist.reshape(q.shape[0], n_tiles, tile_n), dim=-1, stable=True)
        v, i = v[..., :kk], i[..., :kk] + base[None, :, None]
        i = torch.where(v == float("inf"), base[None, :, None], i)
        out_v[:, r0:r0 + q.shape[0], :kk] = v.permute(1, 0, 2)
        out_i[:, r0:r0 + q.shape[0], :kk] = i.permute(1, 0, 2).to(torch.int32)
    return out_v, out_i


# ---------------------------------------------------------------------------
# Kernels 2 / 2b: approximate per-lane-bin best
# ---------------------------------------------------------------------------

def bf_topk_approx(queries, dataset, pen, tile_n: int, key_pack: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(tile, query, lane bin) best ranking score.

    pen [n_tiles, C, 128] (C = tile_n/128 <= 256) is the per-row penalty:
    float32 0.5*|x|^2 (0 for IP, +inf on padded rows) for float inputs; for
    int8, int32 (|x|^2+1)>>1 with a padded-row sentinel, and with key_pack
    pre-folded as (pen << 8) - slice. Scores are q.x - pen; bin l of tile t
    holds columns t*tile_n + c*128 + l. Returns (values [n_tiles, B, 128] f32
    = -best score, slices [n_tiles, B, 128] uint8).
    """
    if not queries.is_cuda:
        return bf_topk_approx_reference(queries, dataset, pen, tile_n, key_pack)
    _check_operands(queries, dataset)
    B, d = queries.shape
    N = dataset.shape[0]
    int8_mode = queries.dtype == torch.int8
    n_tiles = pen.shape[0]
    if tile_n % 128 or tile_n // 128 > 256 or pen.shape[1:] != (tile_n // 128, 128):
        raise ValueError(f"pen {tuple(pen.shape)} does not fit tile_n={tile_n}")
    if n_tiles * tile_n < N:
        raise ValueError("pen covers fewer rows than the dataset")
    if pen.dtype != (torch.int32 if int8_mode else torch.float32) or pen.device != queries.device:
        raise TypeError("pen must be int32 (int8 data) or float32, on the queries' device")
    if key_pack and not int8_mode:
        raise ValueError("key_pack is an int8 mode")
    pen = pen.contiguous()
    out_v = torch.empty((n_tiles, B, 128), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((n_tiles, B, 128), dtype=torch.uint8, device=queries.device)
    if B == 0 or n_tiles == 0:
        return out_v, out_i
    rc = _lib.lib().cuvs_bf_topk_approx(
        _lib.DTYPE_CODE[queries.dtype], queries.data_ptr(), dataset.data_ptr(), pen.data_ptr(), B, N,
        d, int(tile_n), n_tiles, int(bool(key_pack)), out_v.data_ptr(), out_i.data_ptr(),
        _lib.stream(queries.device))
    _lib.check(rc, "bf_topk_approx")
    LAUNCHES["bf_topk_approx"] += 1
    return out_v, out_i


def bf_topk_approx_reference(queries, dataset, pen, tile_n: int, key_pack: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``bf_topk_approx`` (same contract; the int8
    pools are bit-identical)."""
    B = queries.shape[0]
    N = dataset.shape[0]
    n_tiles, C, _ = pen.shape
    n_pad = n_tiles * tile_n
    dev = queries.device
    out_v = torch.empty((n_tiles, B, 128), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_tiles, B, 128), dtype=torch.uint8, device=dev)
    for r0 in range(0, B, _REF_ROWS):
        q = queries[r0:r0 + _REF_ROWS]
        b = q.shape[0]
        dots = torch.nn.functional.pad(_dots(q, dataset), (0, n_pad - N))
        dots = dots.reshape(b, n_tiles, C, 128)
        if key_pack:
            best = (dots * 256 - pen[None]).amax(dim=2)
            v = -(best >> 8).float()
            s = best & 255
        else:
            # max over slices: the first (lowest) slice wins a tie, as the
            # kernel's strict > does
            best, s = (dots - pen[None]).max(dim=2)
            v = -best.float()
        out_v[:, r0:r0 + b] = v.permute(1, 0, 2)
        out_i[:, r0:r0 + b] = s.to(torch.uint8).permute(1, 0, 2)
    return out_v, out_i


# ---------------------------------------------------------------------------
# Host side: geometry, penalties, pool merge (bf_topk_pallas.fused_bf_topk)
# ---------------------------------------------------------------------------

def _penalty(dataset, dnorms, n_tiles: int, tile_n: int, ip: bool, key_pack: bool):
    N, d = dataset.shape
    C = tile_n // 128
    pad_n = n_tiles * tile_n - N
    if dataset.dtype == torch.int8:
        # pen = round(|x|^2 / 2) in exact integers; padded rows get a large
        # sentinel in place of +inf. key_pack: |dots| <= d*127^2 and the
        # sentinel is 3*d*127^2, so (score << 8 | slice) fits int32.
        if ip:
            pen_flat = torch.zeros((N,), dtype=torch.int32, device=dataset.device)
        else:
            di = dataset.to(torch.int32)
            pen_flat = (((di * di).sum(dim=1) + 1) >> 1).to(torch.int32)
        sentinel = 3 * d * 16129 if key_pack else 1 << 30
        pen = torch.nn.functional.pad(pen_flat, (0, pad_n), value=sentinel)
    else:
        if ip:
            pen_flat = torch.zeros((N,), dtype=torch.float32, device=dataset.device)
        elif dnorms is not None:
            pen_flat = 0.5 * dnorms.to(device=dataset.device, dtype=torch.float32)
        else:
            pen_flat = 0.5 * row_norms(dataset)
        pen = torch.nn.functional.pad(pen_flat, (0, pad_n), value=float("inf"))
    pen = pen.reshape(n_tiles, C, 128)
    if key_pack:
        pen = (pen << 8) - torch.arange(C, dtype=torch.int32, device=pen.device)[None, :, None]
    return pen.contiguous()


def fused_bf_topk(queries, dataset, k: int, tile_n: int = 2048, block_q: int = 1024,
                  ip: bool = False, exact: bool = True, dnorms=None, mxu_n: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest rows. Returns (dists [B,k] min-space, ids [B,k] int32).

    queries [B, d] and dataset [N, d] share one compute dtype (float32,
    bfloat16 or int8). Distances are in that dtype's own space (quantized
    units for int8; callers rescale). ``block_q`` and ``mxu_n`` are the
    reference's TPU VMEM blocking; they change no result and the CUDA kernels
    choose their own blocking.
    """
    B, d = queries.shape
    N = dataset.shape[0]
    if not exact:
        # pool geometry of the reference: C = tile_n/128 <= 256 slices
        if tile_n < 4096 or tile_n % 128 or tile_n > 32768:
            tile_n = 16384
        if N <= tile_n:
            tile_n = -(-N // 128) * 128
    n_tiles = -(-N // tile_n)
    if exact:
        qn = row_norms(queries)
        dn = row_norms(dataset)
        out_v, out_i = bf_topk_exact(queries, dataset, qn, dn, int(k), int(tile_n), ip)
        F = out_v.shape[2]
        pool_v = out_v.permute(1, 0, 2).reshape(B, n_tiles * F)
        pool_i = out_i.permute(1, 0, 2).reshape(B, n_tiles * F)
        tv, tl = _select_topk(pool_v, k, True)
        return tv, torch.gather(pool_i, 1, tl)

    key_pack = dataset.dtype == torch.int8 and 4 * d * 16129 * 256 < 2 ** 31
    pen = _penalty(dataset, dnorms, n_tiles, tile_n, ip, key_pack)
    out_v, out_i = bf_topk_approx(queries, dataset, pen, int(tile_n), key_pack)
    # pool column p = t*128 + lane; stored uint8 = strided slice c;
    # global row id = t*tile_n + c*128 + lane
    pool_v = out_v.permute(1, 0, 2).reshape(B, n_tiles * 128)
    pool_i = out_i.permute(1, 0, 2).reshape(B, n_tiles * 128)
    tv, tl = _select_topk(pool_v, k, True)
    local = torch.gather(pool_i, 1, tl).to(torch.int64)
    ti = ((tl // 128) * tile_n + local * 128 + (tl % 128)).to(torch.int32)
    # tv is the ranking score (dots - pen, min-space); L2 = |q|^2 + 2*score
    if not ip:
        tv = torch.clamp_min(row_norms(queries)[:, None] + 2.0 * tv, 0.0)
    return tv, ti


def search(dataset, dnorms, queries, k: int, metric: DistanceType = DistanceType.L2Expanded,
           compute_dtype=torch.bfloat16, tile_n: Optional[int] = None,
           block_q: Optional[int] = None, exact: bool = True, q_scale=None,
           mxu_n: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force k-NN through the fused kernels (L2 family + IP).

    ``q_scale`` set => the dataset is int8; queries are quantized with the
    same scale, the scan runs in int8 x int8 -> int32, and distances are
    rescaled by q_scale**2 (approximate: refine() for exact). Default tiles:
    2048 rows (exact) and 32768 rows = 256 lane slices (approximate).
    """
    if metric not in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                      DistanceType.InnerProduct):
        raise ValueError(f"fused kernel supports L2/IP, got {metric}")
    ip = metric == DistanceType.InnerProduct
    qf = torch.as_tensor(queries).to(device=dataset.device, dtype=torch.float32)
    if tile_n is None:
        tile_n = 2048 if exact else 32768
    tile_n = int(min(tile_n, max(128, dataset.shape[0])))
    if q_scale is not None:
        q_scale = torch.as_tensor(q_scale, dtype=torch.float32, device=dataset.device)
        qq = torch.clamp(torch.round(qf / q_scale), -127, 127).to(torch.int8)
        dd = dataset
    else:
        qq = qf.to(compute_dtype)
        dd = dataset.to(compute_dtype)
    v, i = fused_bf_topk(qq.contiguous(), dd.contiguous(), int(k), tile_n=tile_n,
                         block_q=int(block_q or 1024), ip=ip, exact=exact, dnorms=dnorms,
                         mxu_n=int(mxu_n or 0))
    if q_scale is not None:
        v = v * (q_scale * q_scale)
    if ip:
        v = -v
    elif metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(torch.clamp_min(v, 0.0))
    return v, i
