"""Python side of the C API — port of ``cuvs_tpu.capi_bridge``.

The C ABI (``capi/cuvs_tpu_c.cpp``, built for the port by
``cuvs_tpu_torch.capi``) hands over raw host pointers and shapes; this module
wraps them zero-copy with ctypes and numpy, copies them to the bridge's
device as tensors, and dispatches into ``cuvs_tpu_torch``. Results are
written back through the caller's output pointers. ``init(platform)`` picks
the device for the whole process, as the C ABI's init does: "cpu" is the
host, "", "gpu" and "cuda" the CUDA card (which must exist). bf16 buffers
are wrapped as 16-bit words and viewed as ``torch.bfloat16``. String
parameters whose key ends in ``dtype`` name torch dtypes.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from cuvs_tpu_torch.utils.device import resolve_device

_ALGOS = None
_DEVICE = None  # set by init(): the C ABI's process-wide device
_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8}


def _algos():
    global _ALGOS
    if _ALGOS is None:
        from cuvs_tpu_torch.neighbors import (brute_force, cagra, hnsw, ivf_flat, ivf_pq,
                                              ivf_rabitq, ivf_sq, tiered_index, vamana)

        _ALGOS = {
            "brute_force": brute_force,
            "ivf_flat": ivf_flat,
            "ivf_pq": ivf_pq,
            "ivf_sq": ivf_sq,
            "ivf_rabitq": ivf_rabitq,
            "cagra": cagra,
            "vamana": vamana,
            "tiered": tiered_index,
            "hnsw": hnsw,
        }
    return _ALGOS


def _device() -> torch.device:
    return _DEVICE if _DEVICE is not None else resolve_device(None)


_HALVES = ("bfloat16", "float16")  # no ctypes type: wrapped as 16-bit words


def _wrap(ptr: int, shape, dtype) -> np.ndarray:
    """The host buffer at ``ptr`` as a numpy array, zero-copy (bf16, f16:
    its 16-bit words as int16)."""
    size = int(np.prod(shape))
    dt = np.dtype(np.int16 if dtype in _HALVES else dtype)
    buf = (np.ctypeslib.as_ctypes_type(dt) * size).from_address(ptr)
    return np.frombuffer(buf, dtype=dt).reshape(shape)


def _tensor(ptr: int, shape, dtype) -> torch.Tensor:
    """A copy of the host buffer at ``ptr`` as a tensor on the bridge's device."""
    t = torch.from_numpy(_wrap(ptr, shape, dtype))
    if dtype in _HALVES:
        t = t.view(_DTYPES[dtype])
    return t.to(_device(), copy=True)


def _params(params_json: str) -> dict:
    params = json.loads(params_json or "{}")
    return {key: _DTYPES.get(val, val) if key.endswith("dtype") and isinstance(val, str) else val
            for key, val in params.items()}


def _write(ptr: int, shape, dtype, values: torch.Tensor) -> None:
    _wrap(ptr, shape, dtype)[:] = values.detach().cpu().numpy().astype(dtype)


def _write_results(out_d_ptr: int, out_i_ptr: int, nq: int, k: int, d, i) -> None:
    _write(out_d_ptr, (nq, k), np.float32, torch.as_tensor(d).float())
    _write(out_i_ptr, (nq, k), np.int32, torch.as_tensor(i).to(torch.int32))


def sync():
    """Drain all in-flight device work (cuvsStreamSync analog)."""
    if _device().type == "cuda":
        torch.cuda.synchronize(_device())
    return True


def init(platform: str):
    """Pick the bridge's device: "cpu" the host; "", "gpu" or "cuda" the
    CUDA card (raises without one); any other name raises."""
    global _DEVICE
    name = (platform or "").lower()
    if name == "cpu":
        _DEVICE = torch.device("cpu")
    elif name in ("", "gpu", "cuda"):
        _DEVICE = resolve_device(None)
    else:
        raise ValueError(f"unknown platform {platform!r}: expected cpu, gpu or cuda")
    return True


def build(algo: str, metric: str, params_json: str, data_ptr: int, n_rows: int, dim: int):
    module = _algos()[algo]
    data = _tensor(data_ptr, (n_rows, dim), np.float32)
    return (algo, module.build(data, metric=metric, **_params(params_json)))


def search(handle, params_json: str, q_ptr: int, n_queries: int, dim: int, k: int,
           out_d_ptr: int, out_i_ptr: int):
    algo, index = handle
    q = _tensor(q_ptr, (n_queries, dim), np.float32)
    d, i = _algos()[algo].search(index, q, int(k), **_params(params_json))
    _write_results(out_d_ptr, out_i_ptr, n_queries, k, d, i)
    return True


def serialize(handle, path: str):
    from cuvs_tpu_torch.utils import serialize as ser

    ser.save(path, handle[1])
    return True


def deserialize(path: str):
    from cuvs_tpu_torch.utils import serialize as ser

    index = ser.load(path, device=_device())
    return (ser.kind_of(index), index)


# ---- typed (DLPack-analog) entry points: runtime dtype dispatch ----

def build_typed(algo: str, metric: str, params_json: str, data_ptr: int, n_rows: int, dim: int,
                dtype: str):
    module = _algos()[algo]
    data = _tensor(data_ptr, (n_rows, dim), dtype)
    return (algo, module.build(data, metric=metric, **_params(params_json)))


def search_typed(handle, params_json: str, q_ptr: int, n_queries: int, dim: int, dtype: str,
                 k: int, out_d_ptr: int, out_i_ptr: int):
    algo, index = handle
    q = _tensor(q_ptr, (n_queries, dim), dtype)
    d, i = _algos()[algo].search(index, q, int(k), **_params(params_json))
    _write_results(out_d_ptr, out_i_ptr, n_queries, k, d, i)
    return True


def extend(handle, ptr: int, n_rows: int, dim: int, dtype: str):
    algo, index = handle
    module = _algos()[algo]
    if not hasattr(module, "extend"):
        raise ValueError(f"{algo} does not support extend")
    return (algo, module.extend(index, _tensor(ptr, (n_rows, dim), dtype)))


# ---- filtered search (the reference's cuvsFilter on every *Search endpoint) ----

def search_filtered(handle, params_json: str, q_ptr: int, n_queries: int, dim: int, dtype: str,
                    k: int, filter_type: int, words_ptr: int, n_words: int, out_d_ptr: int,
                    out_i_ptr: int):
    from cuvs_tpu_torch.neighbors import filters

    algo, index = handle
    q = _tensor(q_ptr, (n_queries, dim), dtype)
    words = _tensor(words_ptr, (int(n_words),), np.int32)  # the uint32 words' bits
    if int(filter_type) == 1:  # bitset: one shared row mask
        flt = filters.bitset_filter(words)
    else:  # bitmap: [n_queries, words_per_row]
        flt = filters.bitmap_filter(words.reshape(n_queries, -1))
    d, i = _algos()[algo].search(index, q, int(k), prefilter=flt, **_params(params_json))
    _write_results(out_d_ptr, out_i_ptr, n_queries, k, d, i)
    return True


# ---- vamana / k-NN graph / refine / tiered / hnsw endpoints ----

def vamana_serialize(handle, path: str):
    from cuvs_tpu_torch.neighbors import vamana

    vamana.serialize(handle[1], path)
    return True


def knn_graph(kind: str, metric: str, params_json: str, x_ptr: int, n_rows: int, dim: int,
              dtype: str, k: int, out_g_ptr: int, out_d_ptr: int):
    """Shared entry of cuvsTpuNnDescentBuild / cuvsTpuAllNeighborsBuild."""
    data = _tensor(x_ptr, (n_rows, dim), dtype)
    p = _params(params_json)
    p.pop("graph_degree", None)  # out_graph's column count wins
    if kind == "nn_descent":
        from cuvs_tpu_torch.neighbors import nn_descent

        g, gd = nn_descent.build(
            data, nn_descent.IndexParams(graph_degree=int(k), metric=metric, **p))
    elif kind == "all_neighbors":
        from cuvs_tpu_torch.neighbors import all_neighbors

        g, gd = all_neighbors.build(data, int(k),
                                    all_neighbors.AllNeighborsParams(metric=metric, **p))
    else:
        raise ValueError(f"unknown knn_graph kind {kind!r}")
    _write(out_g_ptr, (n_rows, k), np.int32, g.to(torch.int32))
    if out_d_ptr:
        _write(out_d_ptr, (n_rows, k), np.float32, gd.float())
    return True


def refine(metric: str, x_ptr: int, xr: int, xc: int, xt: str, q_ptr: int, qr: int, qc: int,
           qt: str, c_ptr: int, cr: int, cc: int, k: int, out_d_ptr: int, out_i_ptr: int):
    from cuvs_tpu_torch.neighbors import refine as refine_mod

    x = _tensor(x_ptr, (xr, xc), xt)
    q = _tensor(q_ptr, (qr, qc), qt)
    cand = _tensor(c_ptr, (cr, cc), np.int32)
    d, i = refine_mod.refine(x, q, cand, int(k), metric=metric)
    _write_results(out_d_ptr, out_i_ptr, qr, k, d, i)
    return True


def tiered_build(upstream_algo: str, metric: str, upstream_params_json: str, min_ann_rows: int,
                 data_ptr: int, n_rows: int, dim: int, dtype: str):
    from cuvs_tpu_torch.neighbors import tiered_index

    module = _algos()[upstream_algo]
    data = _tensor(data_ptr, (n_rows, dim), dtype)
    pj = _params(upstream_params_json)
    ann_params = module.IndexParams(metric=metric, **pj) if pj else None
    return ("tiered", tiered_index.build(module, data, ann_params=ann_params,
                                         min_ann_rows=int(min_ann_rows), metric=metric))


def tiered_compact(handle):
    from cuvs_tpu_torch.neighbors import tiered_index

    return ("tiered", tiered_index.compact(handle[1]))


def hnsw_from_cagra(handle, path: str, hierarchy: str, ef_construction: int):
    from cuvs_tpu_torch.neighbors import hnsw

    hnsw.from_cagra(handle[1], path, hnsw.HnswParams(hierarchy=hierarchy,
                                                     ef_construction=int(ef_construction)))
    return True


def hnsw_load(path: str, metric: str):
    from cuvs_tpu_torch.neighbors import hnsw

    return ("hnsw", hnsw.load(path, metric=metric, device=_device()))


# ---- multi-device API (the reference's mg_cagra.h / mg_ivf_flat.h analogs) ----

def _mg_devices():
    from cuvs_tpu_torch import mg

    return ["cpu"] if _device().type == "cpu" else mg.default_devices()


def mg_build(algo: str, mode: str, metric: str, params_json: str, data_ptr: int, n_rows: int,
             dim: int, dtype: str):
    from cuvs_tpu_torch import mg

    data = _tensor(data_ptr, (n_rows, dim), dtype)
    return mg.build(data, algo=algo, mode=mode, metric=metric, devices=_mg_devices(),
                    **_params(params_json))


def mg_search(index, params_json: str, q_ptr: int, n_queries: int, dim: int, dtype: str, k: int,
              out_d_ptr: int, out_i_ptr: int):
    from cuvs_tpu_torch import mg

    q = _tensor(q_ptr, (n_queries, dim), dtype)
    d, i = mg.search(index, q, int(k), **_params(params_json))
    _write_results(out_d_ptr, out_i_ptr, n_queries, k, d, i)
    return True


def mg_serialize(index, path: str):
    from cuvs_tpu_torch.mg import snmg

    snmg.save(path, index)
    return True


def mg_deserialize(path: str):
    from cuvs_tpu_torch.mg import snmg

    return snmg.load(path, devices=_mg_devices())
