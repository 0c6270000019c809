"""CAGRA through ``cuvs_tpu_torch.neighbors.cagra``: ``cagra.build`` and
``cagra.search`` called as a user calls them. cuVS's ``max_queries`` (the
queries one search launch takes) is the port's ``query_chunk``. The search
keeps its default seed, as cuVS's keeps its fixed ``rand_xor_mask``: the
run's seed varies the data and the build."""

from __future__ import annotations

import torch

from cuvs_tpu_torch.neighbors import cagra

# a configuration's ``compute_dtype``: the type the search scores in
_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build(base: torch.Tensor, cfg: dict, seed: int) -> cagra.Index:
    p = cfg["index"]
    return cagra.build(base, cagra.IndexParams(
        intermediate_graph_degree=p["intermediate_graph_degree"],
        graph_degree=p["graph_degree"], metric=cfg["metric"], build_algo=p["build_algo"],
        refine_ratio=p["refine_ratio"], build_n_probes=p["build_n_probes"],
        seed=int(seed) % (1 << 62)))


def searcher(index: cagra.Index, base: torch.Tensor, cfg: dict):
    """``search(q) -> (distances, ids)``."""
    s = cfg["search"]
    params = cagra.SearchParams(
        itopk_size=s["itopk_size"], search_width=s["search_width"],
        max_iterations=s["max_iterations"], num_random_samplings=s["num_random_samplings"],
        compute_dtype=_DTYPE[s["compute_dtype"]], query_chunk=s["max_queries"])

    def search(q):
        return cagra.search(index, q, s["k"], params)

    return search

