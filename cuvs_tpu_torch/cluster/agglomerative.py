"""Agglomerative (single-linkage) clustering via a minimum spanning tree —
port of ``cuvs_tpu.cluster.agglomerative``.

``cuvs::cluster::agglomerative::single_linkage`` (agglomerative.hpp:107,
build_dendrogram :251; MST cpp/src/cluster/detail/mst.cuh): the k-NN
connectivity graph (``knn_graph.build_knn_graph``) and a Borůvka spanning
forest over it run on the device; the connectivity repair (the nearest
cross-component edge of the smallest component, at most 64 rounds, one
exact unfused brute-force search each), the MST of the forest and the
dendrogram run on the host with scipy, line for line as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from cuvs_tpu_torch.neighbors import brute_force as bf
from cuvs_tpu_torch.neighbors import knn_graph as kg
from cuvs_tpu_torch.utils.device import as_tensor as _on_device

_BIG = 2147483647


def _boruvka_round(comp, chosen, u, v, us, vs, ws, uid):
    """One Borůvka round: every component picks its minimum outgoing edge
    under the strict order (weight, undirected edge id); the roots link
    along the picks. Returns (new component labels, whether any pick)."""
    n = comp.shape[0]
    iota = torch.arange(n, device=comp.device)
    cu, cv = comp[us], comp[vs]
    valid = cu != cv
    wv = torch.where(valid, ws, float("inf"))
    wmin = torch.full((n,), float("inf"), device=ws.device).scatter_reduce_(
        0, cu, wv, "amin", include_self=True)
    eid = torch.where(valid & (wv <= wmin[cu]), uid, _BIG)
    pick = torch.full((n,), _BIG, dtype=torch.int64, device=ws.device).scatter_reduce_(
        0, cu, eid, "amin", include_self=True)
    has = pick < _BIG
    safe = torch.where(has, pick, 0)
    # uint8: a bool scatter_reduce is not supported everywhere
    chosen.scatter_reduce_(0, safe, has.to(torch.uint8), "amax", include_self=True)
    # each root slot links itself to the picked edge's other endpoint:
    # elementwise, no scatter collisions, whichever copy of the edge it picked
    other = comp[u[safe]] + comp[v[safe]] - iota
    parent = torch.where(has, other, iota)
    # 2-cycle break: mutual pairs keep the smaller id as root
    pp = parent[parent]
    parent = torch.where((pp == iota) & (iota < parent), iota, parent)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):  # full path compression
        parent = parent[parent]
    return parent[comp], bool(has.any())


def _boruvka_forest(u, v, w, n: int) -> torch.Tensor:
    """Borůvka minimum spanning forest over an edge list, on the edges'
    device (the cuSLINK mst.cuh analog). Strict keys and a symmetric
    adjacency leave only 2-cycles among the picks, broken by the min-root
    rule, so the forest is unique. Rounds repeat while any component picks
    an edge (one host read a round, ~log n rounds). Returns a bool mask over
    the original (pre-symmetrized) edges."""
    u, v = u.long(), v.long()
    w = w.float()
    nE = u.shape[0]
    # symmetrize: reverse copies share the undirected id
    us, vs, ws = torch.cat([u, v]), torch.cat([v, u]), torch.cat([w, w])
    uid = torch.arange(nE, device=w.device).repeat(2)
    comp = torch.arange(n, device=w.device)
    chosen = torch.zeros((nE,), dtype=torch.uint8, device=w.device)
    picked = True
    while picked:
        comp, picked = _boruvka_round(comp, chosen, u, v, us, vs, ws, uid)
    return chosen.bool()


@dataclasses.dataclass
class SingleLinkageOutput:
    """Mirrors the reference output: dendrogram + flat labels."""

    labels: np.ndarray  # [n]
    dendrogram: np.ndarray  # [n-1, 2] merged cluster ids (scipy linkage style)
    distances: np.ndarray  # [n-1] merge heights
    sizes: np.ndarray  # [n-1] merged cluster sizes


def _connect_smallest(graph, comp, x: torch.Tensor, metric):
    """One repair round: the smallest component joined to its nearest
    outside row (the cross_component_nn analog, exact on the device)."""
    sizes = np.bincount(comp)
    c = int(np.argmin(sizes))
    inside = np.where(comp == c)[0]
    outside = np.where(comp != c)[0]
    index = bf.build(x[torch.from_numpy(outside).to(x.device)], metric=metric)
    dd, ii = bf.search(index, x[torch.from_numpy(inside).to(x.device)], 1)
    dd = dd[:, 0].cpu().numpy()
    jj = outside[ii[:, 0].cpu().numpy()]
    best = int(np.argmin(dd))
    a, b, w = inside[best], jj[best], max(float(dd[best]), 1e-30)
    graph[a, b] = w
    graph[b, a] = w


def _mst_edges(x: torch.Tensor, n_neighbors: int, metric
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """MST over the knn connectivity graph, repaired to full connectivity.

    The Borůvka forest over the n·k knn edges runs on the device; the host
    sees only its ≤ n-1 edges plus the repair edges, so scipy's MST below is
    over that small graph, not the full knn edge list."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    n = x.shape[0]
    k = min(n_neighbors, n - 1)
    nbrs, dists = kg.build_knn_graph(x, k, metric=metric)
    u = torch.arange(n, dtype=torch.int32, device=x.device).repeat_interleave(k)
    v = nbrs.to(torch.int32).reshape(-1)
    w = torch.clamp_min(dists.float().reshape(-1), 1e-30)
    mask = _boruvka_forest(u, v, w, n).cpu().numpy()
    fu, fv, fw = u.cpu().numpy()[mask], v.cpu().numpy()[mask], w.cpu().numpy()[mask]
    graph = sp.csr_matrix((fw, (fu, fv)), shape=(n, n))
    graph = graph.maximum(graph.T)
    for _ in range(64):  # bounded repair rounds
        n_comp, comp = csg.connected_components(graph, directed=False)
        if n_comp == 1:
            break
        _connect_smallest(graph, comp, x, metric)
    mst = csg.minimum_spanning_tree(graph)
    coo = mst.tocoo()
    return coo.row, coo.col, coo.data


def single_linkage(x, n_clusters: int = 2, metric="euclidean", n_neighbors: int = 15,
                   device=None) -> SingleLinkageOutput:
    """Single-linkage clustering (agglomerative.hpp:107 semantics). Host rows
    go to ``device`` (None: the CUDA card); the output is on the host."""
    x = _on_device(x, device).float()
    n = x.shape[0]
    if not (1 <= n_clusters <= n):
        raise ValueError("n_clusters out of range")
    u, v, w = _mst_edges(x, n_neighbors, metric)
    order = np.argsort(w, kind="stable")
    u, v, w = u[order], v[order], w[order]

    # union-find dendrogram build (build_dendrogram :251)
    parent = np.arange(2 * n - 1, dtype=np.int64)
    cluster_of = np.arange(n, dtype=np.int64)
    size = np.ones(2 * n - 1, np.int64)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    children = np.zeros((n - 1, 2), np.int64)
    heights = np.zeros(n - 1, np.float32)
    merged_sizes = np.zeros(n - 1, np.int64)
    next_id = n
    m = 0
    for e in range(len(w)):
        ra, rb = find(u[e]), find(v[e])
        if ra == rb:
            continue
        ca, cb = cluster_of[ra], cluster_of[rb]
        children[m] = (min(ca, cb), max(ca, cb))
        heights[m] = w[e]
        new_size = size[ca] + size[cb]
        merged_sizes[m] = new_size
        parent[ra] = rb
        root = find(rb)
        cluster_of[root] = next_id
        size[next_id] = new_size
        next_id += 1
        m += 1
        if m == n - 1:
            break

    # flat labels: replay the merges below the cut (all but the last
    # n_clusters - 1) on the original points
    cut = max(0, m - (n_clusters - 1))
    parent2 = np.arange(n, dtype=np.int64)

    def find2(a):
        while parent2[a] != a:
            parent2[a] = parent2[parent2[a]]
            a = parent2[a]
        return a

    cnt = 0
    for e in range(len(w)):
        if cnt >= cut:
            break
        ra, rb = find2(u[e]), find2(v[e])
        if ra == rb:
            continue
        parent2[ra] = rb
        cnt += 1
    roots = np.array([find2(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return SingleLinkageOutput(labels=labels.astype(np.int32), dendrogram=children[:m],
                               distances=heights[:m], sizes=merged_sizes[:m])
