"""Indexes carried across from the JAX package.

Each function takes exactly the arrays of a ``cuvs_tpu`` index (after
``np.asarray``) and returns the port's index on ``device``, with the same
layout. A test can then build once in JAX and search in both packages, which
separates search faults from the k-means build's RNG differences. bfloat16
arrays (numpy's ``ml_dtypes`` bfloat16) are carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from cuvs_tpu_torch.distance.pairwise import normalize_metric
from cuvs_tpu_torch.neighbors import brute_force, ivf_common, ivf_flat


def _tensor(a, device, dtype=None):
    if a is None:
        return None
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def brute_force_index_from_numpy(dataset, norms, q_scale, metric, device="cpu"
                                 ) -> brute_force.Index:
    """The port's brute-force index over a reference index's arrays."""
    return brute_force.Index(dataset=_tensor(dataset, device), norms=_tensor(norms, device),
                             q_scale=_tensor(q_scale, device, torch.float32),
                             metric=normalize_metric(metric))


def ivf_flat_index_from_numpy(centers, center_norms, sorted_data, sorted_norms, offsets, sizes,
                              ids, labels, q_scale, metric, window, n_rows, device="cpu"
                              ) -> ivf_flat.Index:
    """The port's IVF-Flat index over a reference index's arrays (the list
    arrays are ``index.lists.offsets/sizes/ids/labels``)."""
    lists = ivf_common.SortedLists(offsets=_tensor(offsets, device, torch.int32),
                                   sizes=_tensor(sizes, device, torch.int32),
                                   labels=_tensor(labels, device, torch.int32),
                                   ids=_tensor(ids, device, torch.int32))
    return ivf_flat.Index(centers=_tensor(centers, device), center_norms=_tensor(center_norms, device),
                          sorted_data=_tensor(sorted_data, device),
                          sorted_norms=_tensor(sorted_norms, device), lists=lists,
                          q_scale=_tensor(q_scale, device, torch.float32),
                          metric=normalize_metric(metric), window=int(window), n_rows=int(n_rows))
