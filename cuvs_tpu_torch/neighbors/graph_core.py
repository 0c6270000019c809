"""CAGRA graph optimization — port of ``cuvs_tpu.neighbors.graph_core``.

Detour-count pruning plus the reverse-edge merge (graph_core.cuh: ``kern_sort``
:77, the fused detour-count prune :206-330, ``kern_make_rev_graph`` :178, the
merge :375). Edge u->v is detourable through w when w precedes v in u's list
and v appears in w's list (CAGRA, arXiv:2308.15136).

Every function here is deterministic and returns exactly the reference's
result on the same graph: detour counts are exact membership tests in
chunks of rows (the chunk changes only the memory used), sorts are stable,
and the reverse graph's two-key sort is one int64 key.
"""

from __future__ import annotations

import numpy as np
import torch

from cuvs_tpu_torch.utils.device import as_tensor as _on_device


def _detour_chunk(K: int, device: torch.device) -> int:
    """Rows per detour-count block: about 2 GiB of working set on the card (at
    most a quarter of the free memory), 64 MB on the host."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = min(2 << 30, free // 4)
    else:
        budget = 1 << 26
    return max(8, budget // max(32 * K * K, 1))  # ~32 bytes per (row, j, i)


def _is_member(values: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """values [R, m] ∈ rows [R, w] (each row its own set) -> bool [R, m]:
    a binary search in each row sorted, exact as a dense compare."""
    s = torch.sort(rows, dim=1).values
    pos = torch.searchsorted(s, values.to(s.dtype).contiguous())
    return torch.gather(s, 1, torch.clamp_max(pos, s.shape[1] - 1)) == values


def _detour_counts(graph: torch.Tensor, chunk: int = 0) -> torch.Tensor:
    """graph [n, K] (rank-sorted). Returns detour counts [n, K] int32.

    count[u, i] = |{ j < i : graph[u, i] in graph[graph[u, j]] }|

    Per chunk of rows, the [chunk, K(j), K(i)] membership is a binary search
    of each two-hop list (the reference compares a dense [chunk, K, K, K]
    block; both are exact). ``chunk`` 0 sizes the block to the device
    (``_detour_chunk``); the counts do not depend on it."""
    n, K = graph.shape
    chunk = min(chunk or _detour_chunk(K, graph.device), max(8, n))
    ar = torch.arange(K, device=graph.device)
    jlt = ar[:, None] < ar[None, :]  # [K(j), K(i)]: j < i
    counts = torch.empty((n, K), dtype=torch.int32, device=graph.device)
    for c0 in range(0, n, chunk):
        gu = graph[c0:c0 + chunk]
        B = gu.shape[0]
        two_hop = graph[gu.long()].reshape(B * K, K)  # row (u, j): graph[graph[u, j]]
        member = _is_member(gu[:, None, :].expand(B, K, K).reshape(B * K, K), two_hop)
        counts[c0:c0 + chunk] = (member.reshape(B, K, K) & jlt).sum(1, dtype=torch.int32)
    return counts


def _prune_by_detour(graph: torch.Tensor, counts: torch.Tensor, out_degree: int) -> torch.Tensor:
    """Keep out_degree edges per node with the smallest (detour count, rank)."""
    K = graph.shape[1]
    key = counts.long() * K + torch.arange(K, device=graph.device)[None, :]
    order = torch.argsort(key, dim=1, stable=True)[:, :out_degree]
    return torch.gather(graph, 1, order)


def _reverse_graph(graph: torch.Tensor, rev_degree: int):
    """Reverse edges grouped per head node, best (lowest) rank first.

    Returns (rev [n, rev_degree] int32, valid [n, rev_degree] bool). The flat
    edge list is sorted by (dst, j*n + src) — one int64 key
    ``dst * n*D + j*n + src``, exact because n*D < 2^31 — and each head node
    gathers the first ``rev_degree`` entries of its segment: the (rank, src)
    order of the reference's sorted atomic append (graph_core.cuh:178)."""
    n, D = graph.shape
    if n * D >= (1 << 31):
        raise ValueError("reverse graph too large for int32 keys; shard first")
    dev = graph.device
    nd = n * D
    src = torch.arange(n, device=dev)[:, None]
    key0 = torch.arange(D, device=dev)[None, :] * n + src  # [n, D] unique
    key = torch.sort((graph.long() * nd + key0).reshape(-1)).values
    dst_s, key_s = key // nd, key % nd
    ids = torch.arange(n, device=dev)
    start = torch.searchsorted(dst_s, ids, side="left")
    end = torch.searchsorted(dst_s, ids, side="right")
    pos = start[:, None] + torch.arange(rev_degree, device=dev)[None, :]
    valid = pos < end[:, None]
    kk = key_s[torch.clamp(pos, 0, nd - 1)]
    rev = torch.where(valid, kk % n, -1).to(torch.int32)
    return rev, valid


def _merge_fwd_rev(fwd: torch.Tensor, rev: torch.Tensor, rev_valid: torch.Tensor,
                   out_degree: int) -> torch.Tensor:
    """Interleave forward and reverse edges, dedup, keep out_degree
    (kern_merge_graph, graph_core.cuh:375): forward edges by rank, with
    reverse edges injected for connectivity."""
    n, Df = fwd.shape
    Dr = rev.shape[1]
    dev = fwd.device
    cand = torch.cat([fwd, torch.where(rev_valid, rev, -1).to(fwd.dtype)], 1)  # [n, Df+Dr]
    # priority: interleave fwd rank i -> 2i, rev rank j -> 2j+1
    pri = torch.cat([2 * torch.arange(Df, device=dev),
                     2 * torch.arange(Dr, device=dev) + 1])[None, :].expand(n, -1)
    C = cand.shape[1]
    # dedup: lexicographic (id, pri) order by two stable passes
    cand_key = torch.where(cand < 0, 1 << 30, cand)
    o1 = torch.argsort(pri, dim=1, stable=True)
    o2 = torch.argsort(torch.gather(cand_key, 1, o1), dim=1, stable=True)
    order = torch.gather(o1, 1, o2)
    cand_s = torch.gather(cand, 1, order)
    pri_s = torch.gather(pri, 1, order)
    dup = torch.zeros_like(cand_s, dtype=torch.bool)
    dup[:, 1:] = cand_s[:, 1:] == cand_s[:, :-1]
    pri_s = torch.where(dup | (cand_s < 0), 2 * C + 7, pri_s)
    keep = torch.argsort(pri_s, dim=1, stable=True)[:, :out_degree]
    out = torch.gather(cand_s, 1, keep)
    # rows with fewer than out_degree unique candidates: fill from fwd
    return torch.where(out >= 0, out, fwd[:, :out_degree])


def optimize(knn_graph, out_degree: int, detour_chunk: int = 0,
             guarantee_connectivity: bool = False, dataset=None, device=None) -> torch.Tensor:
    """CAGRA graph optimization (graph::optimize, cagra_build.cuh:1929).

    knn_graph: [n, K] neighbor ids sorted by distance (K = intermediate
    degree); host data goes to ``device`` (None: the CUDA card). Returns the
    pruned fixed-degree graph [n, out_degree] int32. ``guarantee_connectivity``
    runs the MST-style augmentation afterwards (graph_core.cuh:487-644);
    ``dataset`` lets it pick the shortest cross-component bridges."""
    knn_graph = _on_device(knn_graph, device).to(torch.int32)
    K = knn_graph.shape[1]
    if out_degree > K:
        raise ValueError(f"out_degree {out_degree} > intermediate degree {K}")
    counts = _detour_counts(knn_graph, chunk=detour_chunk)
    fwd = _prune_by_detour(knn_graph, counts, out_degree)
    del counts
    rev, rev_valid = _reverse_graph(fwd, out_degree)
    graph = _merge_fwd_rev(fwd, rev, rev_valid, out_degree)
    if guarantee_connectivity:
        graph = augment_connectivity(graph, dataset=dataset)
    return graph


def connected_components(graph, device=None) -> torch.Tensor:
    """Component label [n] int32 per node of the UNDIRECTED view of ``graph``
    (host data goes to ``device``; None: the CUDA card).

    Min-label propagation: each step every node takes the min label over
    itself, its out-neighbors and its in-edges (scatter-min), then labels are
    path-compressed one hop; steps run to the fixpoint (one host sync each),
    where every node holds its component's smallest id."""
    graph = _on_device(graph, device)
    n, D = graph.shape
    g = graph.long()
    flat = g.reshape(-1)

    def body(lab):
        new = torch.minimum(lab, lab[g].amin(1))  # over out-edges
        new = new.scatter_reduce(0, flat, lab.repeat_interleave(D), reduce="amin")  # in-edges
        return torch.minimum(new, new[new])

    prev = torch.arange(n, device=graph.device)
    lab, it = body(prev), 0
    while it < n and bool((lab != prev).any()):
        lab, prev, it = body(lab), lab, it + 1
    return lab.to(torch.int32)


def augment_connectivity(graph, dataset=None, max_rounds: int = 64, device=None) -> torch.Tensor:
    """Ensure the graph is connected (cagra guarantee_connectivity,
    graph_core.cuh:487-644: MST over cross-component candidate edges).

    Host steps, as in the reference: each round labels the components, and
    every component but the largest bridges to the largest one (its shortest
    sampled bridge when ``dataset`` is given, else its first sampled pair);
    the bridge replaces both endpoints' last (worst-rank) slot. Host data goes
    to ``device`` (None: the CUDA card)."""
    graph = _on_device(graph, device).to(torch.int32)
    dev = graph.device
    D = graph.shape[1]
    xf = None if dataset is None else _on_device(dataset, dev).float()
    for _ in range(max_rounds):
        lab_h = connected_components(graph).cpu().numpy()
        comp_ids, comp_index = np.unique(lab_h, return_inverse=True)
        if len(comp_ids) <= 1:
            break
        root = int(np.argmax(np.bincount(comp_index)))
        graph_h = graph.cpu().numpy().copy()
        for c in range(len(comp_ids)):
            if c == root:
                continue
            members = np.where(comp_index == c)[0]
            others = np.where(comp_index == root)[0]
            # strided samples bound the cost
            ms = members[:: max(1, len(members) // 128)][:128]
            os_ = others[:: max(1, len(others) // 1024)][:1024]
            if xf is not None:
                xm = xf[torch.from_numpy(ms).to(dev)].cpu().numpy()
                xo = xf[torch.from_numpy(os_).to(dev)].cpu().numpy()
                d2 = (xm * xm).sum(1)[:, None] + (xo * xo).sum(1)[None, :] - 2.0 * xm @ xo.T
                mi, oi = np.unravel_index(np.argmin(d2), d2.shape)
                src, dst = int(ms[mi]), int(os_[oi])
            else:
                src, dst = int(ms[0]), int(os_[0])
            graph_h[src, D - 1] = dst
            graph_h[dst, D - 1] = src
        graph = torch.from_numpy(graph_h).to(dev)
    return graph
