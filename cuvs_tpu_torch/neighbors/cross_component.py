"""Cross-component nearest neighbours — port of ``cuvs_tpu.neighbors.cross_component``.

``cuvs::sparse::neighbors::cross_component_nn`` (cross_component_nn.cuh:68):
for each connected component, its nearest point in any OTHER component: the
edges that stitch a spanning forest together. A host loop over components,
each one exact unfused ``brute_force`` build over the rows outside it and a
1-NN search of the rows inside, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from cuvs_tpu_torch.neighbors import brute_force
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


def cross_component_nn(x, components, metric="sqeuclidean", device=None) -> np.ndarray:
    """Returns edges [n_components, 3] float64 numpy: (src_row, dst_row,
    distance), the minimal outgoing edge of each component, in component id
    order. Host rows go to ``device`` (None: the CUDA card)."""
    x = _on_device(x, device).float()
    components = np.asarray(components.cpu() if isinstance(components, torch.Tensor)
                            else components)
    uniq = np.unique(components)
    edges = np.zeros((len(uniq), 3), np.float64)
    for ci, c in enumerate(uniq):
        inside = np.where(components == c)[0]
        outside = np.where(components != c)[0]
        if len(outside) == 0:
            edges[ci] = (inside[0], inside[0], np.inf)
            continue
        index = brute_force.build(x[torch.from_numpy(outside).to(x.device)], metric=metric)
        d, i = brute_force.search(index, x[torch.from_numpy(inside).to(x.device)], 1)
        d = d[:, 0].cpu().numpy()
        best = int(np.argmin(d))
        edges[ci] = (inside[best], outside[int(i[best, 0])], float(d[best]))
    return edges
