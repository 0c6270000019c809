"""Composite index: a logical union of child indexes — port of
``cuvs_tpu.neighbors.composite``.

``cuvs::neighbors::composite::index`` (composite/index.hpp:69): search every
child, merge the top-k. Made by a LOGICAL merge (MergeStrategy,
common.hpp:129-133).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.distance.pairwise import is_min_close
from cuvs_tpu_torch.selection.select_k import merge_parts
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


class CompositeIndex:
    """Children are (module, index, id_offset) triples.

    ``id_offset`` shifts child-local ids into the composite id space
    (children built on disjoint slices of a dataset pass their slice start;
    children with global ids already pass 0).
    """

    def __init__(self, children: Sequence[Tuple[object, object, int]]):
        if not children:
            raise ValueError("composite index needs at least one child")
        self.children = list(children)

    @property
    def size(self) -> int:
        return sum(ix.size for _, ix, _ in self.children)

    def search(self, queries, k: int, prefilter=None, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
        """Search every child with ``module.search(index, queries, k,
        prefilter=prefilter, **kw)`` and merge the top-k. As in the reference
        (composite.py:36-40), every child gets the same ``prefilter``, which
        it reads in its own local ids: a filter over the composite's global
        ids must be cut per child by the caller."""
        parts_d, parts_i = [], []
        metric = getattr(self.children[0][1], "metric", None)
        for module, ix, off in self.children:
            d, i = module.search(ix, queries, k, prefilter=prefilter, **kw)
            parts_d.append(d)
            parts_i.append(i + off)
        select_min = is_min_close(metric) if metric is not None else True
        return merge_parts(parts_d, parts_i, k, select_min=select_min)


def merge(module, indexes: Sequence[object], datasets=None, strategy: str = "logical",
          id_offsets: Optional[Sequence[int]] = None, build_params=None, **kw):
    """Merge indexes (cagra.hpp:2477-2501 MergeStrategy).

    "logical" -> a CompositeIndex view (children offset by the running sum
    of their sizes, or by ``id_offsets``); "physical" -> one index rebuilt by
    ``module.build`` over the concatenated ``datasets`` (host data goes where
    ``module.build`` puts it: ``device`` in ``kw``, else the CUDA card)."""
    if strategy == "logical":
        if id_offsets is None:
            offs, acc = [], 0
            for ix in indexes:
                offs.append(acc)
                acc += ix.size
        else:
            offs = list(id_offsets)
        return CompositeIndex([(module, ix, off) for ix, off in zip(indexes, offs)])
    if strategy == "physical":
        if datasets is None:
            raise ValueError("physical merge needs the datasets")
        device = kw.pop("device", None)
        tensors = [d for d in datasets if isinstance(d, torch.Tensor)]
        if tensors:
            data = torch.cat([_on_device(d, tensors[0].device) for d in datasets])
        else:
            data = np.concatenate([np.asarray(d) for d in datasets])
        if build_params is not None:
            return module.build(data, build_params, device=device)
        return module.build(data, device=device, **kw)
    raise ValueError(f"unknown merge strategy {strategy!r}")
