"""Sparse (CSR) exact k-NN — port of ``cuvs_tpu.neighbors.sparse_brute_force``.

``cuvs::neighbors::brute_force`` over a sparse index (brute_force.hpp:603-693,
batched with batch_size_{index,query}; sparse_knn.cuh over the semiring
sparse distances, sparse_distance.cu). Block densification, as in the
reference: [query_block x feature_tile] and [index_block x feature_tile]
dense tiles, made on the device by one scatter from each block's
(row, col, value) triples (the reference fills them on the host, row by row:
the tiles are the same), dot products summed tile by tile in IEEE fp32, and
the metric epilogue from precomputed sparse norms.

The expanded family (L2, IP, cosine, Hellinger, Jaccard, Dice, RusselRao)
accumulates one product per tile; the semiring tail (L1, Linf, Canberra, Lp,
Hamming, KL, Jensen-Shannon, BrayCurtis, unexpanded L2) accumulates
per-feature terms of a [Q, X, T] broadcast, max-combined for Linf, with a
second accumulator for BrayCurtis. Tiles where the block holds no non-zero
are skipped (one host read each). Each block's k best merge into the running
k best by a stable top-k on the device; ids are int64, as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils.device import as_tensor as _on_device


@dataclasses.dataclass
class SparseIndex:
    indptr: torch.Tensor  # [n+1] int64
    indices: torch.Tensor  # [nnz] int64
    data: torch.Tensor  # [nnz] f32
    n_cols: int
    norms: torch.Tensor  # [n] squared L2
    metric: DistanceType = DistanceType.L2Expanded

    @property
    def size(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.data.device


# metrics computable from the accumulated dot and the row norms: one product
# per tile, possibly on transformed values
_DOT_METRICS = {
    DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
    DistanceType.InnerProduct, DistanceType.CosineExpanded,
    DistanceType.HellingerExpanded, DistanceType.JaccardExpanded,
    DistanceType.DiceExpanded, DistanceType.RusselRaoExpanded,
}
# the semiring tail: per-feature terms accumulated across tiles
_POINTWISE_METRICS = {
    DistanceType.L1, DistanceType.Linf, DistanceType.Canberra,
    DistanceType.LpUnexpanded, DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded, DistanceType.HammingUnexpanded,
    DistanceType.KLDivergence, DistanceType.JensenShannon,
    DistanceType.BrayCurtis,
}


def _csr(indptr, indices, data, device):
    return (_on_device(indptr, device).long(), _on_device(indices, device).long(),
            _on_device(data, device).float())


def _row_sq_norms(indptr, data):
    n = indptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n, device=data.device), indptr.diff())
    return torch.zeros((n,), device=data.device).index_add_(0, rows, data * data)


def build(indptr, indices, data, n_cols: int, metric="sqeuclidean", device=None) -> SparseIndex:
    """A sparse index over CSR arrays; host arrays go to ``device`` (None:
    the CUDA card)."""
    metric = normalize_metric(metric)
    if metric not in _DOT_METRICS | _POINTWISE_METRICS:
        raise ValueError(f"unsupported sparse metric {metric}")
    indptr, indices, data = _csr(indptr, indices, data, device)
    return SparseIndex(indptr, indices, data, int(n_cols), _row_sq_norms(indptr, data), metric)


def from_scipy(csr, metric="sqeuclidean", device=None) -> SparseIndex:
    return build(csr.indptr, csr.indices, csr.data, csr.shape[1], metric, device)


def _block(indptr, indices, data, r0: int, r1: int):
    """The (local row, col, value) triples of rows [r0, r1)."""
    s, e = int(indptr[r0]), int(indptr[r1])
    rows = torch.repeat_interleave(torch.arange(r1 - r0, device=data.device),
                                   indptr[r0:r1 + 1].diff(), output_size=e - s)
    return rows, indices[s:e], data[s:e], r1 - r0


def _densify(block, col_lo: int, col_hi: int) -> torch.Tensor:
    """The block's rows x [col_lo, col_hi) as a dense f32 tile: one scatter,
    entries outside the columns sent to a spare column that is dropped."""
    rows, cols, vals, n_rows = block
    width = col_hi - col_lo
    inside = (cols >= col_lo) & (cols < col_hi)
    out = torch.zeros((n_rows, width + 1), device=vals.device)
    out[rows, torch.where(inside, cols - col_lo, width)] = torch.where(inside, vals, 0.0)
    return out[:, :width]


def _tile_terms(metric, qd, xd, p):
    """Per-feature-tile partial terms for the semiring tail: qd [Q, T],
    xd [X, T] -> ([Q, X] partial, [Q, X] secondary or None). Every term is
    zero where both values are zero, so absent CSR entries contribute
    nothing."""
    q3 = qd[:, None, :]
    x3 = xd[None, :, :]
    diff = q3 - x3
    m = metric
    if m == DistanceType.L1:
        return diff.abs().sum(-1), None
    if m == DistanceType.Linf:
        return diff.abs().amax(-1), None
    if m == DistanceType.Canberra:
        denom = q3.abs() + x3.abs()
        ratio = torch.where(denom > 0, diff.abs() / torch.clamp_min(denom, 1e-30), 0.0)
        return ratio.sum(-1), None
    if m == DistanceType.LpUnexpanded:
        return torch.pow(diff.abs(), p).sum(-1), None
    if m in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        return (diff * diff).sum(-1), None
    if m == DistanceType.HammingUnexpanded:
        return (q3 != x3).float().sum(-1), None
    if m == DistanceType.KLDivergence:
        t = torch.where(q3 > 0, q3 * torch.log(torch.clamp_min(q3, 1e-30)
                                               / torch.clamp_min(x3, 1e-30)), 0.0)
        return t.sum(-1), None
    if m == DistanceType.JensenShannon:
        mean = torch.clamp_min(0.5 * (q3 + x3), 1e-30)
        kx = torch.where(q3 > 0, q3 * torch.log(torch.clamp_min(q3, 1e-30) / mean), 0.0)
        ky = torch.where(x3 > 0, x3 * torch.log(torch.clamp_min(x3, 1e-30) / mean), 0.0)
        return (kx + ky).sum(-1), None
    if m == DistanceType.BrayCurtis:
        return diff.abs().sum(-1), (q3 + x3).abs().sum(-1)
    raise AssertionError(m)


def _pointwise_blocks(metric, qblock, xblock, n_cols: int, feature_tile: int, p: float = 2.0):
    """Semiring-tail distances of one (query block, index block) pair:
    densify per feature tile, accumulate the per-tile terms (sum, or max for
    Linf), then apply the metric finalizer."""
    dev = qblock[2].device
    acc = torch.zeros((qblock[3], xblock[3]), device=dev)
    acc2 = torch.zeros_like(acc) if metric == DistanceType.BrayCurtis else None
    for lo in range(0, n_cols, feature_tile):
        hi = min(lo + feature_tile, n_cols)
        qd, xd = _densify(qblock, lo, hi), _densify(xblock, lo, hi)
        if not bool(qd.any()) and not bool(xd.any()):
            continue
        t, t2 = _tile_terms(metric, qd, xd, p)
        acc = torch.maximum(acc, t) if metric == DistanceType.Linf else acc + t
        if t2 is not None:
            acc2 = acc2 + t2
    m = metric
    if m == DistanceType.LpUnexpanded:
        return torch.pow(acc, 1.0 / p)
    if m == DistanceType.L2SqrtUnexpanded:
        return torch.sqrt(torch.clamp_min(acc, 0.0))
    if m == DistanceType.HammingUnexpanded:
        return acc / n_cols
    if m == DistanceType.JensenShannon:
        return torch.sqrt(torch.clamp_min(0.5 * acc, 0.0))
    if m == DistanceType.BrayCurtis:
        return acc / torch.clamp_min(acc2, 1e-30)
    return acc


def _dot_blocks(metric, qblock, xblock, qn, xn, n_cols: int, feature_tile: int):
    """Expanded-family distances of one (query block, index block) pair: the
    dots summed over the feature tiles where both blocks hold a non-zero,
    then the metric's epilogue."""
    dots = torch.zeros((qblock[3], xblock[3]), device=qn.device)
    for lo in range(0, n_cols, feature_tile):
        hi = min(lo + feature_tile, n_cols)
        qd, xd = _densify(qblock, lo, hi), _densify(xblock, lo, hi)
        if not bool(qd.any()) or not bool(xd.any()):
            continue
        if metric == DistanceType.HellingerExpanded:
            qd, xd = torch.sqrt(torch.clamp_min(qd, 0.0)), torch.sqrt(torch.clamp_min(xd, 0.0))
        dots = dots + qd @ xd.T
    if metric == DistanceType.InnerProduct:
        return -dots
    if metric == DistanceType.CosineExpanded:
        return 1.0 - dots / torch.clamp_min(torch.sqrt(qn)[:, None] * torch.sqrt(xn)[None, :],
                                            1e-30)
    if metric == DistanceType.HellingerExpanded:
        return torch.sqrt(torch.clamp_min(1.0 - dots, 0.0))
    if metric == DistanceType.JaccardExpanded:
        return 1.0 - dots / torch.clamp_min(qn[:, None] + xn[None, :] - dots, 1e-30)
    if metric == DistanceType.DiceExpanded:
        return 1.0 - 2.0 * dots / torch.clamp_min(qn[:, None] + xn[None, :], 1e-30)
    if metric == DistanceType.RusselRaoExpanded:
        return (n_cols - dots) / n_cols
    return torch.clamp_min(qn[:, None] + xn[None, :] - 2.0 * dots, 0.0)


def search(index: SparseIndex, q_indptr, q_indices, q_data, k: int, query_block: int = 4096,
           index_block: int = 32768, feature_tile: int = 8192
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sparse k-NN of query CSR rows against the index. Returns
    (distances [nq, k] f32, ids [nq, k] int64) on the index's device; host
    query arrays go there too. Rows short of k candidates pad with +inf and
    id 0."""
    q_indptr, q_indices, q_data = _csr(q_indptr, q_indices, q_data, index.device)
    nq = q_indptr.shape[0] - 1
    n = index.size
    metric = index.metric
    qn = _row_sq_norms(q_indptr, q_data)
    pointwise = metric in _POINTWISE_METRICS
    if pointwise:
        # the tail materializes [Q, X, T] broadcast terms: modest blocks keep
        # the intermediate near 1 GB
        query_block = min(query_block, 256)
        index_block = min(index_block, 1024)
        feature_tile = min(feature_tile, 1024)
    dev = index.device
    out_d, out_i = [], []
    for qs in range(0, nq, query_block):
        qe = min(qs + query_block, nq)
        qblock = _block(q_indptr, q_indices, q_data, qs, qe)
        best_d = torch.full((qe - qs, 0), float("inf"), device=dev)
        best_i = torch.zeros((qe - qs, 0), dtype=torch.int64, device=dev)
        for xs in range(0, n, index_block):
            xe = min(xs + index_block, n)
            xblock = _block(index.indptr, index.indices, index.data, xs, xe)
            if pointwise:
                dist = _pointwise_blocks(metric, qblock, xblock, index.n_cols, feature_tile)
            else:
                dist = _dot_blocks(metric, qblock, xblock, qn[qs:qe], index.norms[xs:xe],
                                   index.n_cols, feature_tile)
            pv, part = topk(dist, min(k, dist.shape[1]), True)
            keep_d, keep = topk(torch.cat([best_d, pv], 1), k, True)
            best_i = torch.cat([best_i, part + xs], 1).gather(1, keep)
            best_d = keep_d
        pad = k - best_d.shape[1]
        if pad > 0:
            best_d = torch.nn.functional.pad(best_d, (0, pad), value=float("inf"))
            best_i = torch.nn.functional.pad(best_i, (0, pad))
        if metric == DistanceType.L2SqrtExpanded:
            best_d = torch.sqrt(torch.clamp_min(best_d, 0.0))
        if metric == DistanceType.InnerProduct:
            best_d = -best_d
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)

