"""Standalone quantizers — port of ``cuvs_tpu.preprocessing.quantize``.

  * scalar: min/max over the central ``quantile`` mass, fp -> int8 and back
    (scalar.hpp:35);
  * binary: 1 bit per dim against a threshold of zero, the mean or a sampled
    median (binary.hpp:31-55), packed 8 dims to a byte for BitwiseHamming;
  * pq: a standalone product quantizer (pq.hpp:34), trained and encoded by
    ``ivf_pq``'s codebook EM and encoder;
  * vpq: a coarse vector quantizer plus PQ of the residuals (common.hpp:46).

Randomness (the median's sample, the codebooks' initial rows) comes from a
``torch.Generator`` seeded from ``seed``: other draws than the reference's
``jax.random``. Host data goes to ``device`` (None: the CUDA card).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cuvs_tpu_torch.utils.device import as_tensor as _on_device


# ----------------------------------------------------------------------------
# scalar int8
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class ScalarQuantizer:
    min_: torch.Tensor  # 0-d f32
    max_: torch.Tensor  # 0-d f32


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated quantile of a 1-D tensor (numpy's default
    method) by order statistics: ``torch.quantile`` refuses inputs above
    2^24 elements. Positions and weights are float64."""
    pos = q * (x.shape[0] - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    v_lo = torch.kthvalue(x, lo + 1).values.double()
    v_hi = v_lo if hi == lo else torch.kthvalue(x, hi + 1).values.double()
    w = pos - lo
    return (v_lo * (1.0 - w) + v_hi * w).float()


def scalar_train(dataset, quantile: float = 0.99, device=None) -> ScalarQuantizer:
    """Robust min/max over the central ``quantile`` mass (scalar.hpp:35)."""
    x = _on_device(dataset, device).float().reshape(-1)
    lo = (1.0 - quantile) / 2.0
    return ScalarQuantizer(min_=_quantile(x, lo), max_=_quantile(x, 1.0 - lo))


def scalar_transform(q: ScalarQuantizer, dataset) -> torch.Tensor:
    x = _on_device(dataset, q.min_.device).float()
    scale = torch.full_like(q.max_, 255.0) / torch.clamp_min(q.max_ - q.min_, 1e-30)
    return torch.clamp(torch.round((x - q.min_) * scale) - 128.0, -128, 127).to(torch.int8)


def scalar_inverse_transform(q: ScalarQuantizer, codes) -> torch.Tensor:
    scale = torch.clamp_min(q.max_ - q.min_, 1e-30) / torch.full_like(q.max_, 255.0)
    return (_on_device(codes, q.min_.device).float() + 128.0) * scale + q.min_


# ----------------------------------------------------------------------------
# binary 1-bit
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class BinaryQuantizer:
    threshold: torch.Tensor  # [dim]


def binary_train(dataset, threshold: str = "zero", sampling_ratio: float = 0.1, seed: int = 0,
                 device=None) -> BinaryQuantizer:
    """threshold in {"zero", "mean", "sampling_median"} (binary.hpp:31-41)."""
    x = _on_device(dataset, device).float()
    if threshold == "zero":
        t = torch.zeros((x.shape[1],), dtype=torch.float32, device=x.device)
    elif threshold == "mean":
        t = x.mean(0)
    elif threshold == "sampling_median":
        n = x.shape[0]
        m = max(1, int(n * sampling_ratio))
        gen = torch.Generator(device=x.device)
        gen.manual_seed(seed)
        s = torch.sort(x[torch.randperm(n, generator=gen, device=x.device)[:m]], 0).values
        t = 0.5 * (s[(m - 1) // 2] + s[m // 2])  # the mean of the middle two, as numpy's
    else:
        raise ValueError(threshold)
    return BinaryQuantizer(threshold=t)


def binary_transform(q: BinaryQuantizer, dataset) -> torch.Tensor:
    """-> packed uint8 bits [n, ceil(dim/8)], dim 8b + j in bit j of byte b."""
    x = _on_device(dataset, q.threshold.device).float()
    bits = (x > q.threshold[None, :]).to(torch.int32)
    n, d = bits.shape
    b = torch.nn.functional.pad(bits, (0, (-d) % 8)).reshape(n, -1, 8)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=x.device)
    return (b * weights).sum(-1).to(torch.uint8)


# ----------------------------------------------------------------------------
# product quantizer (standalone)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class PQQuantizer:
    codebooks: torch.Tensor  # [pq_dim, book, pq_len]
    dim: int = 0


def pq_train(dataset, pq_dim: int, pq_bits: int = 8, n_iters: int = 25, seed: int = 0,
             device=None) -> PQQuantizer:
    from cuvs_tpu_torch.neighbors.ivf_pq import _init_indices, _train_codebooks

    x = _on_device(dataset, device).float()
    n, dim = x.shape
    pq_len = -(-dim // pq_dim)
    xp = torch.nn.functional.pad(x, (0, pq_dim * pq_len - dim))
    sub = xp.reshape(n, pq_dim, pq_len).transpose(0, 1).contiguous()
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    books = _train_codebooks(sub, _init_indices(gen, pq_dim, n, 1 << pq_bits), n_iters)
    return PQQuantizer(codebooks=books, dim=dim)


def pq_transform(q: PQQuantizer, dataset) -> torch.Tensor:
    from cuvs_tpu_torch.neighbors.ivf_pq import _encode

    x = _on_device(dataset, q.codebooks.device).float()
    pq_dim, _, pq_len = q.codebooks.shape
    return _encode(torch.nn.functional.pad(x, (0, pq_dim * pq_len - x.shape[1])), q.codebooks)


def pq_inverse_transform(q: PQQuantizer, codes) -> torch.Tensor:
    pq_dim = q.codebooks.shape[0]
    c = _on_device(codes, q.codebooks.device).long()
    rec = q.codebooks[torch.arange(pq_dim, device=c.device)[None, :], c]  # [n, pq_dim, pq_len]
    return rec.reshape(c.shape[0], -1)[:, :q.dim]


# ----------------------------------------------------------------------------
# VPQ: vector quantization (coarse) + product quantization (residual)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class VPQQuantizer:
    """VQ + PQ dataset codec (cuVS ``vpq_params`` / ``vpq_dataset``,
    common.hpp:46-101, :411)."""

    vq_centers: torch.Tensor  # [vq_n_centers, dim]
    pq: PQQuantizer  # residual codebooks


def vpq_train(dataset, vq_n_centers: int = 256, pq_dim: int = 0, pq_bits: int = 8,
              kmeans_n_iters: int = 25, seed: int = 0, device=None) -> VPQQuantizer:
    from cuvs_tpu_torch.cluster import kmeans_balanced

    x = _on_device(dataset, device).float()
    n, dim = x.shape
    pq_dim = pq_dim or max(1, dim // 4)
    k = min(vq_n_centers, n)
    vq = kmeans_balanced.fit(x, k, kmeans_balanced.BalancedParams(n_clusters=k,
                                                                  n_iters=kmeans_n_iters,
                                                                  seed=seed))
    res = x - vq[kmeans_balanced.predict(x, vq).long()]
    return VPQQuantizer(vq_centers=vq, pq=pq_train(res, pq_dim, pq_bits, n_iters=kmeans_n_iters,
                                                   seed=seed))


def vpq_encode(q: VPQQuantizer, dataset):
    """-> (vq_codes [n] int32, pq_codes [n, pq_dim] uint8)."""
    from cuvs_tpu_torch.cluster import kmeans_balanced

    x = _on_device(dataset, q.vq_centers.device).float()
    labels = kmeans_balanced.predict(x, q.vq_centers)
    return labels.to(torch.int32), pq_transform(q.pq, x - q.vq_centers[labels.long()])


def vpq_decode(q: VPQQuantizer, vq_codes, pq_codes) -> torch.Tensor:
    vq = _on_device(vq_codes, q.vq_centers.device).long()
    return q.vq_centers[vq] + pq_inverse_transform(q.pq, pq_codes)
