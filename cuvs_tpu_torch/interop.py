"""Indexes carried across from the JAX package.

Each function takes exactly the arrays of a ``cuvs_tpu`` index (after
``np.asarray``) and returns the port's index on ``device`` (None: the CUDA
card, which must exist; pass ``device="cpu"`` for the host), with the same
layout. A test can then build once in JAX and search in both packages, which
separates search faults from the k-means build's RNG differences. bfloat16
arrays (numpy's ``ml_dtypes`` bfloat16, or the 2-byte void records that
numpy loads from a file without ``ml_dtypes``) are carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from cuvs_tpu_torch.distance.pairwise import normalize_metric
from cuvs_tpu_torch.neighbors import (ball_cover, brute_force, cagra, ivf_common, ivf_flat, ivf_pq,
                                      ivf_rabitq, ivf_sq, scann, vamana)
from cuvs_tpu_torch.preprocessing import pca
from cuvs_tpu_torch.utils.device import resolve_device


def _tensor(a, device, dtype=None):
    if a is None:
        return None
    device = resolve_device(device)
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        # ml_dtypes bfloat16, or the raw 2-byte records numpy loads it as
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _words(a, device):
    """uint32 code words as int32 tensors with the same bits (core.bitpack)."""
    if a is None:
        return None
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32)).to(resolve_device(device))


def _lists(offsets, sizes, ids, labels, device) -> ivf_common.SortedLists:
    return ivf_common.SortedLists(offsets=_tensor(offsets, device, torch.int32),
                                  sizes=_tensor(sizes, device, torch.int32),
                                  labels=_tensor(labels, device, torch.int32),
                                  ids=_tensor(ids, device, torch.int32))


def brute_force_index_from_numpy(dataset, norms, q_scale, metric, device=None,
                                 metric_arg: float = 2.0) -> brute_force.Index:
    """The port's brute-force index over a reference index's arrays."""
    return brute_force.Index(dataset=_tensor(dataset, device), norms=_tensor(norms, device),
                             q_scale=_tensor(q_scale, device, torch.float32),
                             metric=normalize_metric(metric), metric_arg=float(metric_arg))


def ivf_flat_index_from_numpy(centers, center_norms, sorted_data, sorted_norms, offsets, sizes,
                              ids, labels, q_scale, metric, window, n_rows, device=None,
                              adaptive_centers: bool = False) -> ivf_flat.Index:
    """The port's IVF-Flat index over a reference index's arrays (the list
    arrays are ``index.lists.offsets/sizes/ids/labels``)."""
    return ivf_flat.Index(centers=_tensor(centers, device), center_norms=_tensor(center_norms, device),
                          sorted_data=_tensor(sorted_data, device),
                          sorted_norms=_tensor(sorted_norms, device),
                          lists=_lists(offsets, sizes, ids, labels, device),
                          q_scale=_tensor(q_scale, device, torch.float32),
                          metric=normalize_metric(metric), window=int(window), n_rows=int(n_rows),
                          adaptive_centers=bool(adaptive_centers))


def ivf_pq_index_from_numpy(centers, center_norms, centers_rot, rotation, pq_centers,
                            sorted_codes, offsets, sizes, ids, labels, metric, window, n_rows,
                            pq_bits, sorted_codes_t=None, sorted_code_norms=None, device=None,
                            codebook_gen: str = "per_subspace", pq_dim: int = 0) -> ivf_pq.Index:
    """The port's IVF-PQ index over a reference index's arrays. A
    PER_CLUSTER index (``pq_centers`` [n_lists, book, pq_len]) names its
    ``pq_dim``; a PER_SUBSPACE one takes it from ``pq_centers``. The
    reference's serving layout is taken as it is: its word rows padded to a
    multiple of 8 and its norms padded for a 1024-row DMA window are read by
    index and the pads ignored."""
    if codebook_gen == "per_cluster" and not pq_dim:
        raise ValueError("a per_cluster index needs its pq_dim")
    return ivf_pq.Index(centers=_tensor(centers, device),
                        center_norms=_tensor(center_norms, device),
                        centers_rot=_tensor(centers_rot, device),
                        rotation=_tensor(rotation, device), pq_centers=_tensor(pq_centers, device),
                        sorted_codes=_words(sorted_codes, device),
                        lists=_lists(offsets, sizes, ids, labels, device),
                        metric=normalize_metric(metric), window=int(window), n_rows=int(n_rows),
                        pq_bits=int(pq_bits), codebook_gen=codebook_gen,
                        pq_dim_static=int(pq_dim or np.shape(pq_centers)[0]),
                        sorted_codes_t=_words(sorted_codes_t, device),
                        sorted_code_norms=_tensor(sorted_code_norms, device))


def ivf_rabitq_index_from_numpy(centers, center_norms, rotation, centers_rot, sorted_codes,
                                sorted_fadd, sorted_frescale, offsets, sizes, ids, labels,
                                metric, window, n_rows, bits_per_dim, sorted_codes_t=None,
                                device=None) -> ivf_rabitq.Index:
    """The port's IVF-RaBitQ index over a reference index's arrays (its
    transposed words padded to a multiple of 8 rows are taken as they are)."""
    return ivf_rabitq.Index(centers=_tensor(centers, device),
                            center_norms=_tensor(center_norms, device),
                            rotation=_tensor(rotation, device),
                            centers_rot=_tensor(centers_rot, device),
                            sorted_codes=_words(sorted_codes, device),
                            sorted_fadd=_tensor(sorted_fadd, device),
                            sorted_frescale=_tensor(sorted_frescale, device),
                            lists=_lists(offsets, sizes, ids, labels, device),
                            metric=normalize_metric(metric), window=int(window),
                            n_rows=int(n_rows), bits_per_dim=int(bits_per_dim),
                            sorted_codes_t=_words(sorted_codes_t, device))


def ivf_sq_index_from_numpy(centers, center_norms, sorted_codes, sorted_norms, q_min, q_max,
                            offsets, sizes, ids, labels, metric, window, n_rows, device=None
                            ) -> ivf_sq.Index:
    """The port's IVF-SQ index over a reference index's arrays."""
    return ivf_sq.Index(centers=_tensor(centers, device),
                        center_norms=_tensor(center_norms, device),
                        sorted_codes=_tensor(sorted_codes, device),
                        sorted_norms=_tensor(sorted_norms, device),
                        q_min=_tensor(q_min, device, torch.float32),
                        q_max=_tensor(q_max, device, torch.float32),
                        lists=_lists(offsets, sizes, ids, labels, device),
                        metric=normalize_metric(metric), window=int(window), n_rows=int(n_rows))


def cagra_index_from_numpy(dataset, dataset_norms, graph, metric, device=None) -> cagra.Index:
    """The port's CAGRA index over a reference index's arrays, so both
    packages search the same graph (raw storage; bf16 rows bit for bit)."""
    return cagra.Index(dataset=_tensor(dataset, device),
                       dataset_norms=_tensor(dataset_norms, device, torch.float32),
                       graph=_tensor(graph, device, torch.int32), metric=normalize_metric(metric))


def cagra_compressed_index_from_numpy(vq_centers, vq_codes, pq_codes, pq_codebooks,
                                      dataset_norms, graph, metric, device=None
                                      ) -> cagra.CompressedIndex:
    """The port's VPQ-compressed CAGRA index over a reference index's arrays."""
    return cagra.CompressedIndex(vq_centers=_tensor(vq_centers, device, torch.float32),
                                 vq_codes=_tensor(vq_codes, device, torch.int32),
                                 pq_codes=_tensor(pq_codes, device, torch.uint8),
                                 pq_codebooks=_tensor(pq_codebooks, device, torch.float32),
                                 dataset_norms=_tensor(dataset_norms, device, torch.float32),
                                 graph=_tensor(graph, device, torch.int32),
                                 metric=normalize_metric(metric))


def cagra_packed_index_from_numpy(graph, child_vecs, child_norms, dataset_int8, dataset_norms,
                                  scale, metric, device=None) -> cagra.PackedIndex:
    """The port's packed CAGRA index over a reference index's arrays
    (``child_vecs`` a sequence of pieces, padded tail rows included)."""
    return cagra.PackedIndex(graph=_tensor(graph, device, torch.int32),
                             child_vecs=tuple(_tensor(cv, device, torch.int8)
                                              for cv in child_vecs),
                             child_norms=_tensor(child_norms, device, torch.float32),
                             dataset_int8=_tensor(dataset_int8, device, torch.int8),
                             dataset_norms=_tensor(dataset_norms, device, torch.float32),
                             scale=_tensor(scale, device, torch.float32).reshape(()),
                             metric=normalize_metric(metric))


def vamana_index_from_numpy(dataset, graph, medoid, metric, device=None) -> vamana.Index:
    """The port's Vamana index over a reference index's arrays (graph -1
    padded)."""
    return vamana.Index(dataset=_tensor(dataset, device, torch.float32),
                        graph=_tensor(graph, device, torch.int32), medoid=int(medoid),
                        metric=normalize_metric(metric))


def scann_index_from_numpy(centers, labels, soar_labels, codes, pq_codebooks, residuals_bf16,
                           codes_soar=None, bf16_dataset=None, params=None, device=None
                           ) -> scann.Index:
    """The port's ScaNN index over a reference index's arrays (None where the
    reference holds None). ``params`` is the reference's ``IndexParams`` or
    the port's: the port's is rebuilt from its fields."""
    if params is not None:
        params = scann.IndexParams(**{f: getattr(params, f)
                                      for f in scann.IndexParams.__dataclass_fields__})
    return scann.Index(centers=_tensor(centers, device, torch.float32),
                       labels=_tensor(labels, device, torch.int32),
                       soar_labels=_tensor(soar_labels, device, torch.int32),
                       codes=_tensor(codes, device, torch.uint8),
                       pq_codebooks=_tensor(pq_codebooks, device, torch.float32),
                       residuals_bf16=_tensor(residuals_bf16, device, torch.bfloat16),
                       codes_soar=_tensor(codes_soar, device, torch.uint8),
                       bf16_dataset=_tensor(bf16_dataset, device, torch.bfloat16),
                       params=params)


def ball_cover_index_from_numpy(centers, center_norms, sorted_data, sorted_norms, offsets, sizes,
                                ids, labels, q_scale, metric, window, n_rows, radii, device=None,
                                adaptive_centers: bool = False) -> ball_cover.Index:
    """The port's ball-cover index over a reference index's arrays: its inner
    IVF-Flat index's (as ``ivf_flat_index_from_numpy`` takes them) and the
    cells' ``radii``."""
    inner = ivf_flat_index_from_numpy(centers, center_norms, sorted_data, sorted_norms, offsets,
                                      sizes, ids, labels, q_scale, metric, window, n_rows,
                                      device=device, adaptive_centers=adaptive_centers)
    return ball_cover.Index(inner=inner, radii=_tensor(radii, device, torch.float32))


def pca_from_numpy(mean, components, explained_variance, device=None) -> pca.PCA:
    """The port's PCA over a reference fit's arrays."""
    return pca.PCA(mean=_tensor(mean, device, torch.float32),
                   components=_tensor(components, device, torch.float32),
                   explained_variance=_tensor(explained_variance, device, torch.float32))


def mg_index_from_numpy(shards, row_offsets, algo: str, mode: str, n_rows: int, devices=None):
    """The port's multi-device index over a reference ``MGIndex``'s parts.

    ``shards`` is the reference's stacked per-shard index (``MGIndex.shards``,
    or any object with its fields as attributes): every array leaf has a
    leading [n_shards] axis. Shard s of each leaf goes through the per-algo
    constructor above (through ``utils.serialize``'s table of them) onto
    devices[s % len(devices)] (None: every CUDA device); a replicated
    index's one replica is placed on every device."""
    import dataclasses
    import itertools

    from cuvs_tpu_torch.mg import snmg
    from cuvs_tpu_torch.utils import serialize
    from cuvs_tpu_torch.utils.device import index_to

    devices = snmg._devices(devices)
    arrays, statics = {}, {}
    for f in dataclasses.fields(shards):
        v = getattr(shards, f.name)
        key = "." + f.name
        if v is None:
            continue
        if hasattr(v, "_asdict"):  # SortedLists
            arrays.update({f"{key}.{name}": np.asarray(a) for name, a in v._asdict().items()})
        elif isinstance(v, tuple):  # the packed CAGRA's child_vecs pieces
            arrays.update({f"{key}[{i}]": np.asarray(a) for i, a in enumerate(v)})
        elif hasattr(v, "shape"):
            arrays[key] = np.asarray(v)
        else:
            statics[f.name] = int(v) if hasattr(v, "value") else v
    n_shards = len(next(iter(arrays.values())))
    parts = [serialize._build(algo, {key: a[s] for key, a in arrays.items()}, statics, dev)
             for s, dev in zip(range(n_shards), itertools.cycle(devices))]
    if mode == "replicated":
        return snmg.MGIndex(shards=[index_to(parts[0], dev) for dev in devices],
                            row_offsets=[0] * len(devices), algo=algo, mode=mode,
                            n_rows=int(n_rows))
    return snmg.MGIndex(shards=parts, row_offsets=[int(o) for o in np.asarray(row_offsets)],
                        algo=algo, mode=mode, n_rows=int(n_rows))
