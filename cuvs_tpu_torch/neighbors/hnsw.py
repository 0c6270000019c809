"""HNSW interop: CAGRA graphs in the hnswlib file format — port of
``cuvs_tpu.neighbors.hnsw``.

``cuvs::neighbors::hnsw`` (hnsw.hpp:43-61; detail/hnsw.hpp: layout notes
:975-996, header order :483-509, element records :1040+). A CAGRA graph is
the base layer of an HNSW index; hierarchy "none" writes a base-layer-only
file (cuVS's patched hnswlib reads it), "cpu" and "tpu" (or "gpu": the
port's device, the reference's default HnswHierarchy::GPU) also draw
hnswlib levels and write exact upper-layer link lists, which vanilla
hnswlib descends.

Per element (hnsw.hpp:993-996): [u32 link_count][maxM0 x u32 links]
[dim x f32 data][u64 label]. Header, in order: offsetLevel0, max_elements,
cur_element_count, size_data_per_element, label_offset, offset_data,
maxlevel (i32), enterpoint (i32), maxM, maxM0, M, mult (f64),
ef_construction. The files are written from numpy records, byte for byte
the reference's. ``load`` reads the base layer back into a CAGRA index and
``search`` runs CAGRA's beam search on it, so a round trip needs no hnswlib.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

import numpy as np
import torch

from cuvs_tpu_torch.neighbors import cagra as cagra_mod

_HEAD = "<6Q2i3QdQ"  # the header fields above, 96 bytes


@dataclasses.dataclass(frozen=True)
class HnswParams:
    """Mirrors hnsw::index_params (hnsw.hpp:43-61)."""

    # "none" = base layer only | "cpu" = levels linked on the host |
    # "tpu" / "gpu" = levels linked on the port's device
    hierarchy: str = "none"
    ef_construction: int = 200
    seed: int = 0


def _level_knn_host(sub: np.ndarray, kk: int) -> np.ndarray:
    """Row-blocked exact kNN of a level on the host (hierarchy="cpu")."""
    nl = sub.shape[0]
    sn = (sub * sub).sum(1)
    block = max(1, (64 << 20) // max(nl * 4, 1))  # ~64 MB per block
    links_local = np.empty((nl, kk), np.int64)
    for r0 in range(0, nl, block):
        r1 = min(r0 + block, nl)
        d2 = sn[r0:r1, None] + sn[None, :] - 2.0 * (sub[r0:r1] @ sub.T)
        d2[np.arange(r0, r1) - r0, np.arange(r0, r1)] = np.inf
        part = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
        ord_ = np.argsort(np.take_along_axis(d2, part, axis=1), axis=1)
        links_local[r0:r1] = np.take_along_axis(part, ord_, axis=1)
    return links_local


def _level_knn_device(sub: np.ndarray, kk: int, metric, device=None) -> np.ndarray:
    """Exact kNN of a level on the device (hierarchy "tpu"/"gpu", the
    reference's default HnswHierarchy::GPU, hnsw.hpp:46,51): unfused brute
    force, k + 1, then the row's own id dropped wherever it ranks."""
    from cuvs_tpu_torch.neighbors import brute_force

    ix = brute_force.build(sub, metric=metric, device=device)
    _, ids = brute_force.search(ix, ix.dataset, kk + 1)
    ids = ids.cpu().numpy().astype(np.int64)
    self_col = ids == np.arange(ids.shape[0])[:, None]
    keep = np.argsort(self_col, axis=1, kind="stable")[:, :kk]
    return np.take_along_axis(ids, keep, axis=1)


def _build_hierarchy(data: np.ndarray, m: int, mult: float, seed: int, device: bool = False,
                     metric="sqeuclidean", torch_device=None):
    """hnswlib levels (floor(-ln(U) * mult), U from ``np.random.default_rng
    (seed)`` as in the reference) and exact upper-layer k-NN graphs.

    Returns (levels [n] int32, {level: (node ids, links [len, m'] int32 in
    global ids)}). Upper layers hold n / M^l nodes, so exact k-NN is cheap
    and better than hnswlib's greedy inserts."""
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    levels = np.floor(-np.log(rng.random(n)) * mult).astype(np.int32)
    layers = {}
    for lvl in range(1, int(levels.max()) + 1):
        nodes = np.where(levels >= lvl)[0]
        if len(nodes) == 0:
            break
        if len(nodes) == 1:
            layers[lvl] = (nodes, np.full((1, 0), 0, np.int32))
            continue
        sub = data[nodes]
        kk = min(m, len(nodes) - 1)
        if device:
            links_local = _level_knn_device(sub, kk, metric, torch_device)
        else:
            links_local = _level_knn_host(sub, kk)
        layers[lvl] = (nodes, nodes[links_local].astype(np.int32))
    return levels, layers


def from_cagra(cagra_index, path: str, params: HnswParams = HnswParams()) -> None:
    """Write a CAGRA index as an hnswlib file (hnsw::from_cagra). The
    device hierarchy links its levels on the index's device."""
    graph = cagra_index.graph.cpu().numpy().astype(np.uint32)
    data = cagra_index.dataset.float().cpu().numpy()
    n, deg = graph.shape
    dim = data.shape[1]
    m = (deg + 1) // 2
    max_m0 = 2 * m  # deg rounded up to even
    size_links0 = max_m0 * 4 + 4
    size_per_elem = size_links0 + dim * 4 + 8
    mult = 1.0 / np.log(max(m, 2))

    if params.hierarchy in ("cpu", "tpu", "gpu"):
        levels, layers = _build_hierarchy(
            data, m, mult, params.seed, device=params.hierarchy != "cpu",
            metric=getattr(cagra_index, "metric", "sqeuclidean"),
            torch_device=cagra_index.graph.device)
        maxlevel = int(levels.max()) if n else 0
        enterpoint = int(np.argmax(levels))
    elif params.hierarchy == "none":
        levels, layers = np.zeros(n, np.int32), {}
        maxlevel, enterpoint = 1, n // 2  # the base-only convention (hnsw.hpp:467-468)
    else:
        raise NotImplementedError(f"hierarchy {params.hierarchy!r}")

    base = np.zeros(n, np.dtype([("count", "<i4"), ("links", "<u4", (max_m0,)),
                                 ("data", "<f4", (dim,)), ("label", "<u8")]))
    base["count"] = deg
    base["links"][:, :deg] = graph
    base["data"] = data
    base["label"] = np.arange(n)
    # per element, its upper-level link lists (hnswlib linkLists_): [u32 bytes]
    # then one [i32 count][m x u32 links] record per level 1..level(i)
    words = 1 + levels.astype(np.int64) * (1 + m)
    starts = np.cumsum(words) - words
    upper = np.zeros(int(words.sum()), np.uint32)
    upper[starts] = (m * 4 + 4) * levels.astype(np.int64)
    for lvl, (nodes, links) in layers.items():
        at = starts[nodes] + 1 + (lvl - 1) * (1 + m)
        upper[at] = links.shape[1]
        upper[at[:, None] + 1 + np.arange(links.shape[1])] = links.astype(np.uint32)
    with open(path, "wb") as f:
        f.write(struct.pack(_HEAD, 0, n, n, size_per_elem, size_links0 + dim * 4, size_links0,
                            maxlevel, enterpoint, m, max_m0, m, mult, params.ef_construction))
        f.write(base.tobytes())
        f.write(upper.tobytes())


def _header(f):
    (_, _, n, size_per_elem, label_offset, offset_data, maxlevel, enterpoint, _, max_m0, m,
     _, _) = struct.unpack(_HEAD, f.read(struct.calcsize(_HEAD)))
    return n, size_per_elem, label_offset, offset_data, maxlevel, enterpoint, max_m0, m


def load(path: str, metric="sqeuclidean", device=None):
    """Read an hnswlib file's base layer back into a CAGRA index on
    ``device`` (None: the CUDA card). Rows with fewer links than the widest
    repeat their first link."""
    with open(path, "rb") as f:
        n, size_per_elem, label_offset, offset_data, _, _, max_m0, _ = _header(f)
        dim = (label_offset - offset_data) // 4
        blob = f.read(n * size_per_elem)
    arr = np.frombuffer(blob, np.uint8).reshape(n, size_per_elem)
    counts = arr[:, :4].copy().view(np.int32)[:, 0]
    links = arr[:, 4:4 + max_m0 * 4].copy().view(np.uint32).reshape(n, max_m0)
    deg = int(counts.max()) if n else 0
    graph = links[:, :deg].astype(np.int32)
    col = np.arange(deg)[None, :]
    graph = np.where(col < counts[:, None], graph, graph[:, :1])
    data = arr[:, offset_data:offset_data + dim * 4].copy().view(np.float32)
    return cagra_mod.from_graph(data.reshape(n, dim), graph, metric=metric, device=device)


def read_hierarchy(path: str):
    """The upper-level structure of an hnswlib file (hnswlib's loadIndex
    layout): (levels [n], maxlevel, enterpoint, {(node, level): links})."""
    with open(path, "rb") as f:
        n, size_per_elem, _, _, maxlevel, enterpoint, _, m = _header(f)
        f.seek(n * size_per_elem, 1)
        words = np.frombuffer(f.read(), np.uint32)
    size_links_upper = m * 4 + 4
    levels = np.zeros(n, np.int32)
    links = {}
    pos = 0
    for i in range(n):  # records have their own lengths: walk them
        li = int(words[pos]) // size_links_upper
        pos += 1
        levels[i] = li
        for lvl in range(1, li + 1):
            cnt = int(words[pos].view(np.int32))
            links[(i, lvl)] = words[pos + 1:pos + 1 + cnt].astype(np.int64)
            pos += 1 + m
    return levels, maxlevel, enterpoint, links


def search(index, queries, k: int, ef: int = 64, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a loaded HNSW (a CAGRA index) with CAGRA's beam search, itopk
    max(ef, k) (hnsw::search analog)."""
    return cagra_mod.search(index, queries, k, itopk_size=max(ef, k), **kw)
