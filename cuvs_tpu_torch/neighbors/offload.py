"""Host-offloaded sharded index: serve datasets larger than the card — port
of ``cuvs_tpu.neighbors.offload``.

The dataset-scale ladder after sharding over cards (``cuvs_tpu_torch.mg``):
per-shard sub-indexes whose tensors live in host RAM, pinned, and stream
through the card one shard at a time at search (snmg.cuh:127-166 composed
with host-resident data). Peak device memory is one shard plus one batch of
partial results. ``HostRefinedIndex`` is the other shape: a quantized index
on the card and the raw rows in host RAM (or on disk behind a reader), with
the candidates re-ranked exactly by ``refine_host``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, List, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType, is_min_close
from cuvs_tpu_torch.selection.select_k import merge_parts
from cuvs_tpu_torch.utils import serialize as ser
from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.device import index_to, map_tensors

_ALGOS = ("brute_force", "ivf_flat", "ivf_pq", "ivf_sq", "ivf_rabitq", "cagra")
MAGIC = "cuvs_tpu.offload_index"


def _module(algo: str):
    if algo not in _ALGOS:
        raise ValueError(f"unknown algo {algo!r}")
    return importlib.import_module(f"cuvs_tpu_torch.neighbors.{algo}")


@dataclasses.dataclass
class OffloadIndex:
    """Per-shard sub-indexes whose tensors live in host memory (pinned where
    a CUDA device exists)."""

    algo: str
    shards: List[Any]
    row_offsets: List[int]
    n_rows: int
    metric: Any = DistanceType.L2Expanded

    @property
    def size(self) -> int:
        return self.n_rows


def _to_host(index) -> Any:
    """The index with its tensors in host memory, pinned when a CUDA device
    exists so the copies to the card can run asynchronously."""
    pin = torch.cuda.is_available()

    def host(t):
        out = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=pin)
        return out.copy_(t)
    return map_tensors(index, host)


def _to_device(index, device) -> Any:
    """The index on ``device``; copies from pinned memory do not block."""
    return index_to(index, device, non_blocking=True)


def _is_reader(dataset) -> bool:
    return hasattr(dataset, "read") and hasattr(dataset, "n_rows")


def build(dataset, algo: str = "ivf_pq", n_shards: int = 8, index_params=None, device=None,
          **build_kw) -> OffloadIndex:
    """Build shard at a time: only one shard's rows and sub-index are ever on
    the card. ``dataset`` is an array, a tensor, or a reader with ``n_rows``
    and ``read(start, count) -> np.ndarray`` (e.g. ``io.BinDataset`` over an
    out-of-core .fbin file). Shards are built on ``device`` (None: the card;
    a tensor dataset keeps its device)."""
    module = _module(algo)
    reader = _is_reader(dataset)
    n = int(dataset.n_rows if reader else dataset.shape[0])
    block = -(-n // n_shards)
    shards, offsets = [], []
    for s in range(n_shards):
        lo, hi = s * block, min((s + 1) * block, n)
        if lo >= hi:
            break
        rows = dataset.read(lo, hi - lo) if reader else dataset[lo:hi]
        sub = (module.build(rows, index_params, device=device) if index_params is not None
               else module.build(rows, device=device, **build_kw))
        shards.append(_to_host(sub))
        offsets.append(lo)
        del sub, rows
    metric = getattr(shards[0], "metric", DistanceType.L2Expanded) if shards \
        else DistanceType.L2Expanded
    return OffloadIndex(algo=algo, shards=shards, row_offsets=offsets, n_rows=n, metric=metric)


def search(index: OffloadIndex, queries, k: int, device=None, **search_kw
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Stream the shards through the card: copy shard i over, search the
    whole batch against it, keep its [nq, k] part, release it; then merge
    the parts. Queries go to ``device`` (None: the card; a tensor keeps its
    device). Returns host numpy arrays, as the reference does."""
    module = _module(index.algo)
    queries = _on_device(queries, device)
    select_min = is_min_close(index.metric)
    parts_d, parts_i = [], []
    for sub_host, off in zip(index.shards, index.row_offsets):
        sub = _to_device(sub_host, queries.device)
        d, i = module.search(sub, queries, min(k, sub.size), **search_kw)
        parts_d.append(d)
        parts_i.append(i + off)
        del sub, d, i
    out_d, out_i = merge_parts(parts_d, parts_i, k, select_min=select_min)
    return out_d.cpu().numpy(), out_i.cpu().numpy()


@dataclasses.dataclass
class HostRefinedIndex:
    """A quantized ANN index on the card + the raw vectors on the host.

    The card holds only the ranking index (e.g. an int8 or PQ IVF); the raw
    f32 rows stay in host RAM (or on disk behind a reader), and every search
    re-ranks its k * ratio candidates exactly through ``refine_host``, so
    only those rows cross to the card. snmg.cuh:127-166 composed with
    refine_host.hpp."""

    algo: str
    device_index: Any
    host_vectors: Any  # np.ndarray / np.memmap / reader with .read()
    metric: Any = DistanceType.L2Expanded


def build_host_refined(dataset, algo: str = "ivf_flat", index_params=None, device=None,
                       **build_kw) -> HostRefinedIndex:
    """Build the device index over ``dataset`` (on ``device``; None: the card)
    and keep its raw rows on the host as the refine source: a reader or a
    numpy array as given, a tensor copied to host numpy."""
    module = _module(algo)
    if _is_reader(dataset):
        host, rows = dataset, dataset.read(0, dataset.n_rows)
    else:
        host = dataset.cpu().numpy() if isinstance(dataset, torch.Tensor) else np.asarray(dataset)
        rows = dataset
    sub = (module.build(rows, index_params, device=device) if index_params is not None
           else module.build(rows, device=device, **build_kw))
    return HostRefinedIndex(algo=algo, device_index=sub, host_vectors=host,
                            metric=getattr(sub, "metric", DistanceType.L2Expanded))


def search_refined(index: HostRefinedIndex, queries, k: int, refine_ratio: int = 4, **search_kw
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized ranking on the card, then an exact host re-rank of
    k * refine_ratio candidates (``refine.refine_host``: only the candidate
    rows are gathered on the host and copied over)."""
    from cuvs_tpu_torch.neighbors import refine as refine_mod

    module = _module(index.algo)
    dev = index.device_index.device
    queries = _on_device(queries, dev)
    _, cand = module.search(index.device_index, queries, max(k, k * refine_ratio), **search_kw)
    return refine_mod.refine_host(index.host_vectors, queries, cand, k, metric=index.metric)


def save(path: str, index: OffloadIndex) -> None:
    """One index file per shard + a distribution header (the snmg.cuh:46-90
    per-rank layout)."""
    ser.write_dir_header(path, "offload_header.json", MAGIC, {
        "algo": index.algo, "n_rows": int(index.n_rows),
        "row_offsets": [int(o) for o in index.row_offsets]})
    for s, shard in enumerate(index.shards):
        ser.save(ser.shard_path(path, s), shard)


def load(path: str) -> OffloadIndex:
    """Read an offloaded index (either package's directory); the shards stay
    in host memory."""
    header = ser.read_dir_header(path, "offload_header.json", MAGIC)
    shards = [_to_host(ser.load(ser.shard_path(path, s), device="cpu"))
              for s in range(len(header["row_offsets"]))]
    metric = getattr(shards[0], "metric", DistanceType.L2Expanded)
    return OffloadIndex(algo=header["algo"], shards=shards,
                        row_offsets=[int(o) for o in header["row_offsets"]],
                        n_rows=int(header["n_rows"]), metric=metric)
