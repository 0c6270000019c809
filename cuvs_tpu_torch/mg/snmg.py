"""Multi-device (SNMG) sharded and replicated indexes — port of ``cuvs_tpu.mg.snmg``.

``cuvs::neighbors::mg_index`` (common.hpp:948-1026; snmg.cuh): REPLICATED
copies the index to every device and routes query batches; SHARDED builds
one index per contiguous block of rows, sends every query to every shard
and merges the partial top-k. As in the reference (one process over a
``Mesh``) and in cuVS (one process, a host thread per rank), one process
drives a list of devices: ``devices`` is a sequence of ``torch.device``,
and a device may repeat, so four shards can share one card.

The shards are not stacked: ``MGIndex.shards`` is a list of the port's
per-shard indexes, each on its device, of whatever size its rows give it.
So shards of unequal shapes need no padding to a common one (the
reference's ``_unify_windows``, ``_unify_rows`` and ``_pad_to_common``).
Search issues the shards in turn, copies each [nq, k] part to the root
device (the first shard's) and merges them there in shard order with a
stable top-k, so ties fall as in the reference's ``lax.top_k``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.core import bitset
from cuvs_tpu_torch.distance.pairwise import DistanceType, is_min_close
from cuvs_tpu_torch.neighbors import brute_force, cagra, filters as filt, ivf_flat, ivf_pq
from cuvs_tpu_torch.selection.select_k import merge_parts
from cuvs_tpu_torch.utils import serialize as ser
from cuvs_tpu_torch.utils.device import index_to, resolve_device

_ALGOS = {
    "brute_force": brute_force,
    "ivf_flat": ivf_flat,
    "ivf_pq": ivf_pq,
    "cagra": cagra,
}

MAGIC = "cuvs_tpu.mg_index"


@dataclasses.dataclass
class MGIndex:
    """Per-shard indexes, each on its device, and their global id offsets.

    SHARDED: shard s holds rows [row_offsets[s], row_offsets[s] + its size).
    REPLICATED: one replica per device, all over every row (offsets 0)."""

    shards: List[Any]
    row_offsets: List[int]
    algo: str = "cagra"
    mode: str = "sharded"
    n_rows: int = 0


def default_devices() -> List[torch.device]:
    """Every visible CUDA device; raises without one (``resolve_device``)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices(devices) -> List[torch.device]:
    return [torch.device(d) for d in (devices if devices is not None else default_devices())]


def _build_one(module, rows, device, index_params, kw):
    if index_params is not None:
        return module.build(rows, index_params, device=device)
    return module.build(rows, device=device, **kw)


def _rows(dataset, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of a tensor or a host array on ``device`` (a view where
    they are there already)."""
    rows = dataset[lo:hi]
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(device)


def build(dataset, algo: str = "cagra", mode: str = "sharded", devices: Optional[Sequence] = None,
          index_params=None, distributed_build: str = "auto", **kw) -> MGIndex:
    """Build a multi-device index over ``devices`` (None: every CUDA device).

    SHARDED: contiguous blocks of ceil(n / S) rows, the last one shorter
    (snmg.cuh:127-166); shard s is built on devices[s]. REPLICATED: one build
    on devices[0], copied to each other device; a repeated device shares the
    same tensors (snmg.cuh:97-126).

    ``distributed_build`` "auto"/"on" builds sharded IVF-Flat with coarse
    centres trained once over every row (see ``_build_ivf_flat_sharded``);
    "off" builds each shard on its own."""
    devices = _devices(devices)
    module = _ALGOS[algo]
    n = int(dataset.shape[0])
    if mode == "replicated":
        index = _build_one(module, _rows(dataset, 0, n, devices[0]), devices[0], index_params, kw)
        return MGIndex(shards=[index_to(index, dev) for dev in devices],
                       row_offsets=[0] * len(devices), algo=algo, mode="replicated", n_rows=n)
    if mode != "sharded":
        raise ValueError(f"unknown mode {mode!r}: sharded or replicated")
    block = -(-n // len(devices))
    if algo == "ivf_flat" and distributed_build in ("auto", "on"):
        return _build_ivf_flat_sharded(dataset, n, block, devices, index_params, kw)
    shards, offsets = [], []
    for s, dev in enumerate(devices):
        lo, hi = s * block, min(n, (s + 1) * block)
        if lo >= hi:
            break
        shards.append(_build_one(module, _rows(dataset, lo, hi, dev), dev, index_params, kw))
        offsets.append(lo)
    return MGIndex(shards=shards, row_offsets=offsets, algo=algo, mode="sharded", n_rows=n)


def _build_ivf_flat_sharded(dataset, n: int, block: int, devices, index_params, kw) -> MGIndex:
    """Sharded IVF-Flat over one set of coarse centres.

    The centres are trained once, over every row, with the
    ``kmeans_balanced.fit`` call ``ivf_flat.build`` makes, so they are those
    of a single-device build on the same rows; every shard then labels and
    packs its own rows (``ivf_flat._pack``) into an inverted file of its
    own, as the per-rank builds of snmg.cuh:127-166 do. int8 storage
    quantizes every shard with one global scale."""
    params = index_params or ivf_flat.IndexParams(**kw)
    root = devices[0]
    n_lists = min(params.n_lists, block)
    xf = _rows(dataset, 0, n, root).float()
    centers = kmeans_balanced.fit(
        xf, n_lists,
        kmeans_balanced.BalancedParams(n_clusters=n_lists, n_iters=params.kmeans_n_iters,
                                       trainset_fraction=params.kmeans_trainset_fraction,
                                       seed=params.seed))
    cosine = params.metric == DistanceType.CosineExpanded
    if cosine:  # cosine lists are built on normalized geometry, as in ivf_flat.build
        centers = centers / torch.clamp_min(torch.linalg.norm(centers, dim=1, keepdim=True), 1e-30)
    q_scale = None
    if params.storage_dtype == torch.int8 and _rows(dataset, 0, 0, "cpu").dtype != torch.int8:
        q_scale = torch.clamp_min(xf.abs().max(), 1e-30) / 127.0
    del xf
    shards, offsets = [], []
    for s, dev in enumerate(devices):
        lo, hi = s * block, min(n, (s + 1) * block)
        if lo >= hi:
            break
        rows = _rows(dataset, lo, hi, dev)
        rf = rows.float()
        if cosine:
            rf = rf / torch.clamp_min(torch.linalg.norm(rf, dim=1, keepdim=True), 1e-30)
        c = centers.to(dev)
        labels = kmeans_balanced.predict(rf, c)
        del rf
        ids = torch.arange(hi - lo, dtype=torch.int32, device=dev)
        shards.append(ivf_flat._pack(rows, ids, labels, c, params.metric, n_lists,
                                     params.adaptive_centers, params.storage_dtype,
                                     q_scale=None if q_scale is None else q_scale.to(dev)))
        offsets.append(lo)
    return MGIndex(shards=shards, row_offsets=offsets, algo="ivf_flat", mode="sharded", n_rows=n)


def build_streaming(slice_provider, n_slices: int, devices: Optional[Sequence] = None,
                    n_lists: int = 16384, metric=None, trainset_rows: int = 2_000_000,
                    kmeans_n_iters: int = 10, seed: int = 0, algo: str = "ivf_flat",
                    **algo_kw) -> MGIndex:
    """Sharded streaming IVF build for sources larger than the cards.

    Contiguous groups of ceil(n_slices / S) host slices go to each shard;
    shard s is built by ``<algo>.build_streaming`` (ivf_flat: int8 rows;
    ivf_pq: packed PQ codes) directly on devices[s], so a card holds its own
    finished shards and the one under construction. The last shards may get
    fewer slices, or none (then there are fewer shards).

    ``slice_provider(i) -> [rows, d]`` host numpy array, i in [0, n_slices);
    called up to 3 times per slice. ``trainset_rows`` and ``n_lists`` apply
    per shard; ``algo_kw`` goes to the per-shard builder (pq_dim, pq_bits)."""
    if metric is None:
        metric = DistanceType.L2Expanded
    if algo not in ("ivf_flat", "ivf_pq"):
        raise ValueError(f"build_streaming supports ivf_flat/ivf_pq, got {algo}")
    devices = _devices(devices)
    if n_slices < len(devices):
        raise ValueError(f"need >= 1 slice per shard ({n_slices} slices, {len(devices)} shards)")
    module = _ALGOS[algo]
    per = -(-n_slices // len(devices))
    shards, offsets, row0 = [], [], 0
    for s, dev in enumerate(devices):
        lo, hi = s * per, min((s + 1) * per, n_slices)
        if lo >= hi:
            break
        sub = module.build_streaming(lambda i, lo=lo: slice_provider(lo + i), hi - lo,
                                     n_lists=n_lists, metric=metric, trainset_rows=trainset_rows,
                                     kmeans_n_iters=kmeans_n_iters, seed=seed, device=dev,
                                     **algo_kw)
        shards.append(sub)
        offsets.append(row0)
        row0 += sub.n_rows
    return MGIndex(shards=shards, row_offsets=offsets, algo=algo, mode="sharded", n_rows=row0)


def _shard_filter(prefilter: Optional[filt.Prefilter], offset: int, rows: int):
    """A prefilter over global ids as the shard's local ids read it: a bitset
    or bitmap cut to the shard's range of bits, a UDF called with the ids
    shifted by the offset (the reference's wrapper, snmg.py:521-530)."""
    if prefilter is None or prefilter.is_none:
        return prefilter
    if prefilter.kind in ("bitset", "bitmap"):
        words = prefilter.bits
        mask = bitset.bitset_to_mask(words, words.shape[-1] * bitset.BITS)[..., offset:offset + rows]
        if mask.shape[-1] < rows:  # rows past the filter's end do not pass
            mask = torch.nn.functional.pad(mask, (0, rows - mask.shape[-1]))
        return filt.Prefilter(kind=prefilter.kind, bits=bitset.bitset_from_mask(mask))
    return filt.udf_filter(lambda qid, sid: filt.passes(prefilter, qid, sid + offset))


_rr_counter = [0]  # ROUND_ROBIN batch counter (snmg.cuh:639 atomic counter)
_rr_lock = threading.Lock()  # concurrent searchers tick it atomically


def search(mg: MGIndex, queries, k: int, prefilter: Optional[filt.Prefilter] = None,
           routing: str = "load_balancer", **search_kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-device search (snmg.cuh:561-650). Returns (distances [nq, k],
    ids [nq, k] global int32) on the root device, the first shard's.

    SHARDED: every shard searches the whole batch with the prefilter read in
    its own ids; its ids are shifted to global ones, and a global id >=
    n_rows (a padded row of a shard loaded from the reference's files) gets
    the worst distance and id 0 before the merge. REPLICATED, by ``routing``
    (common.hpp:948-976): "round_robin" sends the whole batch to one replica,
    the next one on each call; "load_balancer" splits it evenly over the
    replicas and concatenates their results in order."""
    module = _ALGOS[mg.algo]
    root = mg.shards[0].device
    if not isinstance(queries, torch.Tensor):
        queries = torch.as_tensor(np.asarray(queries), device=root)
    if mg.mode == "replicated":
        if routing == "round_robin":
            with _rr_lock:
                tick = _rr_counter[0]
                _rr_counter[0] += 1
            replica = mg.shards[tick % len(mg.shards)]
            d, i = module.search(replica, queries.to(replica.device), k, prefilter=prefilter,
                                 **search_kw)
            return d.to(root), i.to(root)
        nq = queries.shape[0]
        per = -(-nq // len(mg.shards))
        parts_d, parts_i = [], []
        for r, replica in enumerate(mg.shards):
            q = queries[r * per:(r + 1) * per]
            if q.shape[0] == 0:
                break
            qids_filter = _query_slice_filter(prefilter, r * per, q.shape[0])
            d, i = module.search(replica, q.to(replica.device), k, prefilter=qids_filter,
                                 **search_kw)
            parts_d.append(d.to(root))
            parts_i.append(i.to(root))
        return torch.cat(parts_d), torch.cat(parts_i)

    metric = getattr(mg.shards[0], "metric", DistanceType.L2Expanded)
    select_min = is_min_close(metric)
    bad = float("inf") if select_min else float("-inf")
    parts_d, parts_i = [], []
    for shard, off in zip(mg.shards, mg.row_offsets):
        d, i = module.search(shard, queries.to(shard.device), k,
                             prefilter=_shard_filter(prefilter, off, shard.size), **search_kw)
        d, i = d.to(root), i.to(root) + off
        pad_hit = i >= mg.n_rows
        parts_d.append(torch.where(pad_hit, bad, d))
        parts_i.append(torch.where(pad_hit, 0, i))
    return merge_parts(parts_d, parts_i, k, select_min=select_min)


def _query_slice_filter(prefilter, start: int, count: int):
    """A per-query prefilter as a slice of the batch reads it: a bitmap's
    rows [start, start + count), a UDF's query ids shifted by start."""
    if prefilter is None or prefilter.kind in ("none", "bitset"):
        return prefilter
    if prefilter.kind == "bitmap":
        return filt.Prefilter(kind="bitmap", bits=prefilter.bits[start:start + count])
    return filt.udf_filter(lambda qid, sid: filt.passes(prefilter, qid + start, sid))


def save(path: str, mg_index: MGIndex) -> None:
    """Per-shard index files ``shard_{s}.npz`` and the distribution header
    ``mg_header.json`` (snmg.cuh:46-90 serializes per-rank sub-indexes the
    same way). A replicated index writes its one replica."""
    shards = mg_index.shards if mg_index.mode == "sharded" else mg_index.shards[:1]
    offsets = mg_index.row_offsets if mg_index.mode == "sharded" else [0]
    ser.write_dir_header(path, "mg_header.json", MAGIC, {
        "algo": mg_index.algo, "mode": mg_index.mode, "n_rows": int(mg_index.n_rows),
        "n_shards": len(shards), "row_offsets": [int(o) for o in offsets]})
    for s, shard in enumerate(shards):
        ser.save(ser.shard_path(path, s), shard)


def load(path: str, devices: Optional[Sequence] = None) -> MGIndex:
    """Read a multi-device index (the port's or the reference's directory),
    checking the header. Shard s goes to devices[s % len(devices)]; a
    replicated index is copied to every device (None: every CUDA device)."""
    devices = _devices(devices)
    header = ser.read_dir_header(path, "mg_header.json", MAGIC)
    algo = header["algo"]
    if header["mode"] == "replicated":
        first = ser.load(ser.shard_path(path, 0), expected_kind=algo, device=devices[0])
        shards = [index_to(first, dev) for dev in devices]
        offsets = [0] * len(devices)
    else:
        shards = [ser.load(ser.shard_path(path, s), expected_kind=algo, device=dev)
                  for s, dev in zip(range(header["n_shards"]), itertools.cycle(devices))]
        offsets = [int(o) for o in header["row_offsets"]]
    return MGIndex(shards=shards, row_offsets=offsets, algo=algo, mode=header["mode"],
                   n_rows=int(header["n_rows"]))
