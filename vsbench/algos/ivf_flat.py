"""IVF-Flat through ``cuvs_tpu_torch.neighbors.ivf_flat``."""

from __future__ import annotations

import torch

from cuvs_tpu_torch.neighbors import ivf_flat
from vsbench import reference, roofline


def build(base: torch.Tensor, cfg: dict, seed: int) -> ivf_flat.Index:
    p = cfg["index"]
    return ivf_flat.build(base, ivf_flat.IndexParams(
        n_lists=p["n_lists"], metric=cfg["metric"], seed=int(seed) % (1 << 62)))


def searcher(index: ivf_flat.Index, base: torch.Tensor, cfg: dict):
    s = cfg["search"]
    params = ivf_flat.SearchParams(n_probes=s["n_probes"])

    def search(q):
        return ivf_flat.search(index, q, s["k"], params)

    return search


def work(index: ivf_flat.Index, base: torch.Tensor, list_sizes: torch.Tensor,
         queries: torch.Tensor, cfg: dict) -> dict:
    s = cfg["search"]
    probes = reference.probe(queries, index.centers, s["n_probes"], cfg["metric"])
    c = roofline.probe_counts(probes, list_sizes)
    return {"ivf_scan": roofline.ivf_flat_scan(c, base.shape[1], s["k"])}
