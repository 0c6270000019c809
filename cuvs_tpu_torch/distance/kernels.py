"""Gram matrices and kernel density estimation — port of ``cuvs_tpu.distance.kernels``.

``cuvs::distance::kernels``: the LINEAR / POLYNOMIAL / RBF / TANH gram
matrices (grammian.hpp:256-344, KernelType distance.hpp:103) and ``kde()``
over the six density kernels (DensityKernelType distance.hpp:93-99,
kde.hpp:48). RBF goes through ``pairwise_distance(L2Expanded)``, the others
through one product (``pairwise._gemm``), in IEEE fp32 (TF32 is off, see
``distance/pairwise.py``). ``kde`` builds one [m, n] block, unchunked, as the
reference does.
"""

from __future__ import annotations

import enum
import math

import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType, _gemm, pairwise_distance
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


class KernelType(enum.IntEnum):
    LINEAR = 0
    POLYNOMIAL = 1
    RBF = 2
    TANH = 3


def gram_matrix(x, y=None, kernel: KernelType = KernelType.LINEAR, gamma: float = 1.0,
                coef0: float = 0.0, degree: int = 3, compute_dtype=torch.float32,
                device=None) -> torch.Tensor:
    """K(x_i, y_j) for the four grammian kernels (grammian.hpp:103-127).
    Host data goes to ``device`` (None: the CUDA card); y follows x."""
    x = _on_device(x, device).float()
    y = x if y is None else _on_device(y, x.device).float()
    if kernel == KernelType.RBF:
        d2 = pairwise_distance(x, y, metric=DistanceType.L2Expanded, compute_dtype=compute_dtype)
        return torch.exp(-gamma * d2)
    dots = _gemm(x, y, compute_dtype)
    if kernel == KernelType.LINEAR:
        return dots
    if kernel == KernelType.POLYNOMIAL:
        return torch.pow(gamma * dots + coef0, degree)
    if kernel == KernelType.TANH:
        return torch.tanh(gamma * dots + coef0)
    raise ValueError(kernel)


class DensityKernelType(enum.IntEnum):
    """Mirrors cuvs DensityKernelType (distance.hpp:93-99)."""

    Gaussian = 0
    Tophat = 1
    Epanechnikov = 2
    Exponential = 3
    Linear = 4
    Cosine = 5


def kde(x, samples, bandwidth: float = 1.0,
        kernel: DensityKernelType = DensityKernelType.Gaussian, metric="euclidean",
        device=None) -> torch.Tensor:
    """Kernel density estimate of ``x`` rows over ``samples`` (kde.hpp:48).

    Returns the unnormalized density sum per query row (the reference leaves
    normalization to the caller). Host data goes to ``device`` (None: the
    CUDA card); samples follow x."""
    d = pairwise_distance(x, samples, metric=metric, device=device) / bandwidth
    k = DensityKernelType(kernel)
    if k == DensityKernelType.Gaussian:
        w = torch.exp(-0.5 * d * d)
    elif k == DensityKernelType.Tophat:
        w = (d < 1.0).float()
    elif k == DensityKernelType.Epanechnikov:
        w = torch.clamp_min(1.0 - d * d, 0.0)
    elif k == DensityKernelType.Exponential:
        w = torch.exp(-d)
    elif k == DensityKernelType.Linear:
        w = torch.clamp_min(1.0 - d, 0.0)
    elif k == DensityKernelType.Cosine:
        w = torch.where(d < 1.0, torch.cos(0.5 * math.pi * d), 0.0)
    else:
        raise ValueError(kernel)
    return w.sum(1)
