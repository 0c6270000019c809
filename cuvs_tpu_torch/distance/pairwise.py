"""Dense pairwise distances — port of ``cuvs_tpu.distance.pairwise``.

The metric enum keeps the reference's integer values
(``cuvs::distance::DistanceType``, distance.hpp:19-66) so indexes and headers
carry over between the two packages.

  * **Expanded family** (L2, L2Sqrt, Cosine, Correlation, InnerProduct,
    Hellinger, RusselRao, Jaccard, Dice): one ``torch.matmul`` ``x @ y.T``
    plus an epilogue on row norms or sums.
  * **Unexpanded family** (L1, Linf, Canberra, Lp, Hamming, BrayCurtis,
    JensenShannon, KLDivergence, L2/L2Sqrt Unexpanded): a broadcast
    map-reduce over [tile, n, d], tiled over query rows so the intermediate
    stays near 256 MB.
  * Haversine on (lat, lon) pairs; BitwiseHamming: popcount of the XOR of
    packed uint8 rows.

Precision: float32 products run at full IEEE fp32. Importing this module turns
TF32 off for CUDA matmuls and cuDNN (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` = False): TF32 keeps ~3 decimal
digits, too few for ground truth. The reference's float32 products use
``lax.Precision.HIGH``, three bf16 passes of about TF32 grade
(``cuvs_tpu/distance/pairwise.py:133-143``); on the CPU both compute plain
fp32, and on the card the port is the more exact of the two. A bfloat16
``compute_dtype`` rounds both operands to bf16 and multiplies the rounded
values in float32 (bf16 x bf16 products are exact in f32), as the reference's
``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from cuvs_tpu_torch.utils.device import as_tensor as _on_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class DistanceType(enum.IntEnum):
    """Mirrors cuvs::distance::DistanceType values (distance.hpp:19-66)."""

    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    BitwiseHamming = 20
    Precomputed = 100


# String aliases accepted by the Python API (cuvs python bindings' names).
_ALIASES = {
    "sqeuclidean": DistanceType.L2Expanded,
    "euclidean": DistanceType.L2SqrtExpanded,
    "l2": DistanceType.L2SqrtExpanded,
    "cosine": DistanceType.CosineExpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "manhattan": DistanceType.L1,
    "taxicab": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "dot": DistanceType.InnerProduct,
    "chebyshev": DistanceType.Linf,
    "linf": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "lp": DistanceType.LpUnexpanded,
    "minkowski": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "kldivergence": DistanceType.KLDivergence,
    "russellrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
    "bitwise_hamming": DistanceType.BitwiseHamming,
}


def normalize_metric(metric) -> DistanceType:
    """Metric name, integer or enum -> DistanceType; a callable (metric UDF,
    ``fn(x [m,d], y [n,d]) -> [m,n]``) passes through unchanged."""
    if callable(metric) and not isinstance(metric, DistanceType):
        return metric
    if isinstance(metric, DistanceType):
        return metric
    if isinstance(metric, int):
        return DistanceType(metric)
    key = str(metric).lower()
    if key in _ALIASES:
        return _ALIASES[key]
    try:
        return DistanceType[metric]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}") from None


def is_min_close(metric) -> bool:
    """Whether smaller distance = more similar (distance.hpp:71-86)."""
    m = normalize_metric(metric)
    if callable(m) and not isinstance(m, DistanceType):
        return True
    return m != DistanceType.InnerProduct


def row_norms(x: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """Per-row L2 norms in float32 (squared by default)."""
    xf = x.float()
    n = (xf * xf).sum(dim=-1)
    return n if squared else torch.sqrt(n)


def matmul_precision(compute_dtype) -> str:
    """The port's counterpart of the reference's MXU precision choice:
    float32 compute is full IEEE fp32 ("highest", TF32 off); lower compute
    dtypes round the operands and multiply them in fp32 ("default")."""
    return "highest" if compute_dtype == torch.float32 else "default"


def _gemm(x: torch.Tensor, y: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """x [m,d] @ y.T [d,n] with operands rounded to ``compute_dtype`` and
    products summed in float32."""
    xc = x.to(compute_dtype).float()
    yc = y.to(compute_dtype).float()
    return xc @ yc.T


def int_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 dot products a [..., m, d] . b [..., n, d]
    -> [..., m, n] (leading dims batch).

    Each partial sum over 1024 dims is at most 1024 * 127^2 < 2^24 in
    magnitude, so a float32 matmul of the int8 values is exact; the partials
    are then summed in int32. Works on CPU and CUDA alike."""
    out = None
    for k0 in range(0, max(1, a.shape[-1]), 1024):
        part = torch.matmul(a[..., k0:k0 + 1024].float(),
                            b[..., k0:k0 + 1024].float().transpose(-1, -2)).to(torch.int32)
        out = part if out is None else out + part
    return out


def _expanded(metric, x, y, compute_dtype=torch.float32, x_norms=None, y_norms=None):
    """Expanded-metric distances [m, n]: one product plus an epilogue."""
    m = metric
    if m == DistanceType.InnerProduct:
        return _gemm(x, y, compute_dtype)  # raw similarity
    if m in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        xn = row_norms(x) if x_norms is None else x_norms
        yn = row_norms(y) if y_norms is None else y_norms
        d = xn[:, None] + yn[None, :] - 2.0 * _gemm(x, y, compute_dtype)
        d = torch.clamp_min(d, 0.0)
        return torch.sqrt(d) if m == DistanceType.L2SqrtExpanded else d
    if m == DistanceType.CosineExpanded:
        xn = row_norms(x, squared=False) if x_norms is None else x_norms
        yn = row_norms(y, squared=False) if y_norms is None else y_norms
        dot = _gemm(x, y, compute_dtype)
        denom = torch.clamp_min(xn[:, None] * yn[None, :], 1e-30)
        return 1.0 - dot / denom
    if m == DistanceType.CorrelationExpanded:
        xf, yf = x.float(), y.float()
        return _expanded(DistanceType.CosineExpanded, xf - xf.mean(1, keepdim=True),
                         yf - yf.mean(1, keepdim=True), compute_dtype)
    if m == DistanceType.HellingerExpanded:
        # sqrt(1 - sum(sqrt(x_i * y_i))) on probability-like inputs
        dot = _gemm(torch.sqrt(torch.clamp_min(x.float(), 0.0)),
                    torch.sqrt(torch.clamp_min(y.float(), 0.0)), torch.float32)
        return torch.sqrt(torch.clamp_min(1.0 - dot, 0.0))
    if m == DistanceType.RusselRaoExpanded:
        k = x.shape[-1]
        return (k - _gemm(x, y, compute_dtype)) / k
    if m == DistanceType.JaccardExpanded:
        dot = _gemm(x, y, compute_dtype)
        union = torch.clamp_min(row_norms(x)[:, None] + row_norms(y)[None, :] - dot, 1e-30)
        return 1.0 - dot / union
    if m == DistanceType.DiceExpanded:
        dot = _gemm(x, y, compute_dtype)
        return 1.0 - 2.0 * dot / torch.clamp_min(row_norms(x)[:, None] + row_norms(y)[None, :],
                                                 1e-30)
    raise AssertionError(m)


_EXPANDED = {
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.CosineExpanded,
    DistanceType.CorrelationExpanded,
    DistanceType.InnerProduct,
    DistanceType.HellingerExpanded,
    DistanceType.RusselRaoExpanded,
    DistanceType.JaccardExpanded,
    DistanceType.DiceExpanded,
}


def _pointwise(metric, xt, y, p):
    """xt [t, 1, d] vs y [1, n, d] -> [t, n] distances (fp32 throughout)."""
    m = metric
    diff = xt - y
    if m in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        d = (diff * diff).sum(-1)
        return torch.sqrt(d) if m == DistanceType.L2SqrtUnexpanded else d
    if m == DistanceType.L1:
        return diff.abs().sum(-1)
    if m == DistanceType.Linf:
        return diff.abs().amax(-1)
    if m == DistanceType.Canberra:
        denom = xt.abs() + y.abs()
        return torch.where(denom > 0, diff.abs() / torch.clamp_min(denom, 1e-30), 0.0).sum(-1)
    if m == DistanceType.LpUnexpanded:
        return torch.pow(torch.pow(diff.abs(), p).sum(-1), 1.0 / p)
    if m == DistanceType.HammingUnexpanded:
        return (xt != y).float().mean(-1)
    if m == DistanceType.BrayCurtis:
        return diff.abs().sum(-1) / torch.clamp_min((xt + y).abs().sum(-1), 1e-30)
    if m == DistanceType.JensenShannon:
        safe = torch.clamp_min(0.5 * (xt + y), 1e-30)
        kx = torch.where(xt > 0, xt * torch.log(torch.clamp_min(xt, 1e-30) / safe), 0.0)
        ky = torch.where(y > 0, y * torch.log(torch.clamp_min(y, 1e-30) / safe), 0.0)
        return torch.sqrt(torch.clamp_min(0.5 * (kx + ky).sum(-1), 0.0))
    if m == DistanceType.KLDivergence:
        return torch.where(xt > 0, xt * torch.log(torch.clamp_min(xt, 1e-30)
                                                  / torch.clamp_min(y, 1e-30)), 0.0).sum(-1)
    raise AssertionError(m)


_UNEXPANDED = {
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.L1,
    DistanceType.Linf,
    DistanceType.Canberra,
    DistanceType.LpUnexpanded,
    DistanceType.HammingUnexpanded,
    DistanceType.BrayCurtis,
    DistanceType.JensenShannon,
    DistanceType.KLDivergence,
}


def _haversine(x, y):
    """x, y: [*, 2] (lat, lon) in radians -> great-circle angle [m, n]."""
    lat1, lon1 = x[:, None, 0], x[:, None, 1]
    lat2, lon2 = y[None, :, 0], y[None, :, 1]
    a = (torch.sin(0.5 * (lat2 - lat1)) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin(0.5 * (lon2 - lon1)) ** 2)
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def _bitwise_hamming(x, y):
    """Differing bits between packed uint8 rows x [m, d] and y [n, d] -> [m, n]."""
    v = torch.bitwise_xor(x.to(torch.uint8)[:, None, :], y.to(torch.uint8)[None, :, :])
    v = v.to(torch.int16)  # popcount of each byte by bit tricks
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return ((v + (v >> 4)) & 0x0F).sum(-1, dtype=torch.float32)


def _row_tile(n: int, d: int, m: int) -> int:
    """Query rows per tile keeping a [tile, n, d] fp32 block near 256 MB (a
    power of two, at least 8)."""
    budget = 256 * 1024 * 1024 // 4
    tile = max(8, min(m, budget // max(n * d, 1)))
    return 1 << (tile.bit_length() - 1)


def _tiled_rows(fn, x, row_tile: int):
    """fn over row tiles of x, concatenated."""
    return torch.cat([fn(x[r:r + row_tile]) for r in range(0, x.shape[0], row_tile)])


def unexpanded(metric, x, y, p: float = 2.0, row_tile: Optional[int] = None):
    """Unexpanded-family distances x [m, d] vs y [n, d] -> [m, n] fp32, over
    row tiles (``row_tile`` None: sized to ~256 MB of [tile, n, d])."""
    xf, yf = x.float(), y.float()
    row_tile = row_tile or _row_tile(yf.shape[0], yf.shape[1], xf.shape[0])
    return _tiled_rows(lambda xt: _pointwise(metric, xt[:, None, :], yf[None], p), xf,
                       row_tile)


def pairwise_distance(x, y, metric="sqeuclidean", p: float = 2.0,
                      row_tile: Optional[int] = None, compute_dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """All-pairs distances between rows of x [m,d] and y [n,d] -> [m,n] fp32.

    Parity: cuvs::distance::pairwise_distance (distance.hpp:163-337).
    ``compute_dtype=torch.bfloat16`` rounds the expanded metrics' operands to
    bf16. Host data goes to ``device`` (None: the CUDA card); y follows x.
    """
    metric = normalize_metric(metric)
    x = _on_device(x, device)
    y = _on_device(y, x.device)
    if callable(metric) and not isinstance(metric, DistanceType):
        return metric(x.float(), y.float()).float()  # metric UDF
    if metric == DistanceType.Precomputed:
        raise ValueError("Precomputed is a tag, not a computable metric")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"bad shapes {tuple(x.shape)} vs {tuple(y.shape)}")
    if row_tile is None:
        row_tile = _row_tile(y.shape[0], y.shape[1], x.shape[0])
    if metric in _EXPANDED:
        return _expanded(metric, x.float(), y.float(), compute_dtype)
    if metric == DistanceType.Haversine:
        return _haversine(x.float(), y.float())
    if metric == DistanceType.BitwiseHamming:
        return _tiled_rows(lambda xt: _bitwise_hamming(xt, y), x, int(row_tile))
    return unexpanded(metric, x, y, float(p), int(row_tile))
