"""Dense epsilon-neighbourhood — port of ``cuvs_tpu.neighbors.epsilon_neighborhood``.

cuvs::neighbors::epsilon_neighborhood (epsilon_neighborhood.hpp): the
boolean within-radius adjacency [m, n] and each row's degree, from one
``pairwise_distance`` and a comparison.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuvs_tpu_torch.distance.pairwise import pairwise_distance


def eps_neighbors(x, y, eps: float, metric="euclidean", row_tile: int = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (adjacency [m, n] bool, degree [m] int32): d(x_i, y_j) <= eps.
    Host data goes to ``device`` (None: the CUDA card); y follows x."""
    d = pairwise_distance(x, y, metric=metric, row_tile=row_tile, device=device)
    adj = d <= eps
    return adj, adj.sum(1, dtype=torch.int32)
