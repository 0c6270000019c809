"""Constraint hooks for YAML param sweeps — port of ``cuvs_tpu.bench.constraints``.

Callables named in each algo YAML under ``constraints:``, invoked per
parameter combination to drop invalid ones before running (cuvs_bench's
config/algos/constraints). Build hooks get (params, dims); search hooks get
(params, build_params, k, batch_size). The rules are the reference's.
"""

from __future__ import annotations

import importlib
import sys

# the reference's configs name its hooks by this prefix
_REFERENCE_PREFIX = "cuvs_tpu.bench.constraints."


def ivf_pq_build(params, dims):
    if params.get("pq_dim", 0) and params["pq_dim"] > dims:
        return False
    if "pq_bits" in params and not (4 <= params["pq_bits"] <= 8):
        return False
    return True


def ivf_pq_search(params, build_params, k, batch_size):
    # refine needs enough PQ candidates to re-rank
    ratio = params.get("refine_ratio", 1.0)
    return ratio >= 1.0


def cagra_build(params, dims):
    g = params.get("graph_degree")
    ig = params.get("intermediate_graph_degree")
    if g is not None and ig is not None:
        return g <= ig
    return True


def cagra_search(params, build_params, k, batch_size):
    itopk = params.get("itopk_size", 64)
    return itopk >= k


def ivf_flat_build(params, dims):
    return params.get("n_lists", 1) >= 1


def ivf_rabitq_build(params, dims):
    return 1 <= params.get("bits_per_dim", 3) <= 9


def resolve(path: str):
    """Dotted-name lookup (``cuvs_tpu_torch.bench.constraints.cagra_build``).

    A hook of the reference's configs (``cuvs_tpu.bench.constraints.<fn>``)
    resolves to this module's ``<fn>``, so the reference's YAML files run as
    they are. Any other name in the JAX package raises: the port never
    imports it."""
    if path.startswith(_REFERENCE_PREFIX):
        fn_name = path[len(_REFERENCE_PREFIX):]
        fn = getattr(sys.modules[__name__], fn_name, None)
        if fn is None or fn_name.startswith("_"):
            raise ValueError(f"no constraint hook {fn_name!r} in cuvs_tpu_torch.bench.constraints")
        return fn
    if path.split(".", 1)[0] == "cuvs_tpu":
        raise ValueError(f"{path!r} names the JAX package, which cuvs_tpu_torch never imports")
    mod_name, fn_name = path.rsplit(".", 1)
    return getattr(importlib.import_module(mod_name), fn_name)
