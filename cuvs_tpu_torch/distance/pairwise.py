"""Dense distances for the search path — port of ``cuvs_tpu.distance.pairwise``.

The metric enum keeps the reference's integer values
(``cuvs::distance::DistanceType``, distance.hpp:19-66) so indexes and headers
carry over between the two packages. The expanded metrics on the search path
(L2, L2Sqrt, InnerProduct, Cosine) are one ``torch.matmul`` plus an epilogue
on row norms.

Precision: float32 products run at full IEEE fp32. Importing this module turns
TF32 off for CUDA matmuls and cuDNN (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` = False), the counterpart of the
reference's ``Precision.HIGHEST``; TF32 keeps ~3 decimal digits, too few for
ground truth. A bfloat16 ``compute_dtype`` rounds both operands to bf16 and
multiplies the rounded values in float32 (bf16 x bf16 products are exact in
f32), as the reference's ``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import enum

import torch

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
    """Expanded-metric distances [m, n] (L2, L2Sqrt, InnerProduct, Cosine)."""
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
    raise NotImplementedError(f"metric {m!r} is not ported yet")

