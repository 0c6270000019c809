"""Fused distance + argmin — port of ``cuvs_tpu.distance.fused_l2_nn``.

The k-means assignment step: per row tile, one matmul against the centers,
the L2 epilogue and an argmin over the center axis, so the [n, k] distance
matrix never exists whole. Ties go to the lowest center, as ``jnp.argmin``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.distance.pairwise import _gemm


def fused_l2_argmin(x: torch.Tensor, y: torch.Tensor, y_norms: Optional[torch.Tensor] = None,
                    row_tile: int = 32768, compute_dtype=torch.float32, sqrt: bool = False,
                    center_weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of x, the nearest row of y under squared L2.

    Returns (labels [m] int32, min_dist [m] f32). ``center_weights`` [k]
    multiplies the squared distances inside the argmin (the kmeans_balanced
    soft-balancing hook); min_dist is then weighted too."""
    yf = y.float()
    if y_norms is None:
        y_norms = (yf * yf).sum(-1)
    labels, vals = [], []
    for r0 in range(0, x.shape[0], max(1, row_tile)):
        xt = x[r0:r0 + row_tile].float()
        xn = (xt * xt).sum(-1)
        dist = torch.clamp_min(xn[:, None] + y_norms[None, :] - 2.0 * _gemm(xt, yf, compute_dtype),
                               0.0)
        if center_weights is not None:
            dist = dist * center_weights[None, :]
        idx = torch.argmin(dist, dim=1)
        labels.append(idx.to(torch.int32))
        vals.append(torch.gather(dist, 1, idx[:, None])[:, 0])
    if not labels:
        return (torch.zeros((0,), dtype=torch.int32, device=x.device),
                torch.zeros((0,), dtype=torch.float32, device=x.device))
    val = torch.cat(vals)
    return torch.cat(labels), torch.sqrt(val) if sqrt else val
