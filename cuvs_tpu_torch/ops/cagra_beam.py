"""CAGRA's beam search on the card: one launch a chunk of queries.

``beam_search`` walks each query's sorted itopk list (``state_v``,
``state_id`` [B, L], ids carrying ``EXPLORED``) through the steps of
``neighbors.cagra._beam_loop`` until no unexplored finite entry is left or
``max_iter`` steps ran, over raw rows (f32 or bf16) scored in f32 or bf16.
For CUDA tensors it launches the hand-written kernel ``csrc/cagra_beam.cu``,
one block a query, and raises on what the kernel does not take; CPU tensors
run the plain version, ``beam_search_reference``: the loop itself.

``fits`` is the layout and shape the kernel takes: raw rows (an ``Index``'s
``data_pack``), f32 or bf16 rows and compute type, the L2 and inner-product
metrics, itopk <= 512 (cuVS's single-CTA limit), search_width * degree <=
1024, a visited ring of at most 1024 slots, d <= 1024 and n < 2^30.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType
from cuvs_tpu_torch.ops import _lib
from cuvs_tpu_torch.utils import tracing

# Kernel launches since the last reset (see ops.bf_topk.LAUNCHES).
LAUNCHES = {"cagra_beam": 0}
MAX_ITOPK, MAX_CANDIDATES, MAX_RING, MAX_DIM, MAX_ROWS = 512, 1024, 1024, 1024, 1 << 30
_TYPES = (torch.float32, torch.bfloat16)
_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded, DistanceType.InnerProduct)


def _within_limits(rows: torch.Tensor, itopk: int, candidates: int, vis_size: int) -> bool:
    return (rows.shape[0] < MAX_ROWS and 1 <= rows.shape[1] <= MAX_DIM and 1 <= itopk <= MAX_ITOPK
            and 1 <= candidates <= MAX_CANDIDATES and vis_size <= MAX_RING)


def fits(data_pack, graph: torch.Tensor, itopk: int, search_width: int, vis_size: int, metric,
         compute_dtype) -> bool:
    """Whether ``beam_search`` takes a chunk of this layout and shape."""
    if len(data_pack) != 1:  # VPQ codes
        return False
    rows = data_pack[0]
    return (rows.dtype in _TYPES and compute_dtype in _TYPES and metric in _METRICS
            and rows.dim() == 2 and rows.is_contiguous()
            and graph.dtype == torch.int32 and graph.is_contiguous()
            and _within_limits(rows, itopk, search_width * graph.shape[1], vis_size))


def beam_search(rows: torch.Tensor, norms: torch.Tensor, graph: torch.Tensor,
                queries: torch.Tensor, qnorm: torch.Tensor, state_v: torch.Tensor,
                state_id: torch.Tensor, search_width: int, max_iter: int, vis_size: int, metric,
                compute_dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The final lists of a chunk's beam searches.

    rows [n, d] f32 or bf16, norms [n] f32 (of the f32 rows), graph [n, deg]
    int32, queries [B, d], qnorm [B] f32 (of the f32 queries), state_v [B, L]
    f32 and state_id [B, L] int32 each query's sorted list. Returns (state_v,
    state_id, counts [B, 3] int32: each query's steps, expanded parents and
    scored children); the inputs are left as they are."""
    if not rows.is_cuda:
        return beam_search_reference(rows, norms, graph, queries, qnorm, state_v, state_id,
                                     search_width, max_iter, vis_size, metric, compute_dtype)
    dev = rows.device
    n, d = rows.shape
    B, L = state_v.shape
    deg = graph.shape[1]
    if any(t.device != dev for t in (norms, graph, queries, qnorm, state_v, state_id)):
        raise ValueError(f"every operand must lie on {dev}")
    if rows.dtype not in _TYPES or compute_dtype not in _TYPES or metric not in _METRICS:
        raise ValueError(f"the kernel takes f32 or bf16 rows and compute type and the L2 or "
                         f"inner-product metrics ({rows.dtype}, {compute_dtype}, {metric})")
    if (norms.dtype != torch.float32 or graph.dtype != torch.int32
            or state_v.dtype != torch.float32 or state_id.dtype != torch.int32):
        raise ValueError("norms and state_v must be float32, graph and state_id int32")
    if not (rows.is_contiguous() and norms.is_contiguous() and graph.is_contiguous()):
        raise ValueError("rows, norms and graph must be contiguous")
    if (norms.shape != (n,) or graph.shape[0] != n or queries.shape != (B, d)
            or qnorm.shape != (B,) or state_id.shape != (B, L)):
        raise ValueError("norms [n], graph [n, deg], queries [B, d], qnorm [B] and "
                         "state_id [B, L] must match rows [n, d] and state_v [B, L]")
    if not _within_limits(rows, L, search_width * deg, vis_size):
        raise ValueError(f"past the kernel's limits: n {n} (< 2^30), d {d} (<= {MAX_DIM}), "
                         f"itopk {L} (<= {MAX_ITOPK}), search_width x degree "
                         f"{search_width * deg} (<= {MAX_CANDIDATES}), ring {vis_size} "
                         f"(<= {MAX_RING})")
    qc = queries.to(compute_dtype).float().contiguous()
    qn = qnorm.float().contiguous()
    out_v = state_v.clone(memory_format=torch.contiguous_format)
    out_id = state_id.clone(memory_format=torch.contiguous_format)
    counts = torch.empty((B, 3), dtype=torch.int32, device=dev)
    rc = _lib.lib().cuvs_cagra_beam(
        _lib.DTYPE_CODE[rows.dtype],
        int(rows.dtype == torch.float32 and compute_dtype == torch.bfloat16), rows.data_ptr(),
        norms.data_ptr(), graph.data_ptr(), qc.data_ptr(), qn.data_ptr(), out_v.data_ptr(),
        out_id.data_ptr(), counts.data_ptr(), n, d, deg, B, L, search_width, max_iter, vis_size,
        int(metric == DistanceType.InnerProduct), _lib.stream(dev))
    _lib.check(rc, "cagra_beam")
    LAUNCHES["cagra_beam"] += 1
    tracing.count("beam_kernel_queries", B)
    return out_v, out_id, counts


def beam_search_reference(rows: torch.Tensor, norms: torch.Tensor, graph: torch.Tensor,
                          queries: torch.Tensor, qnorm: torch.Tensor, state_v: torch.Tensor,
                          state_id: torch.Tensor, search_width: int, max_iter: int,
                          vis_size: int, metric, compute_dtype
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``beam_search`` (same contract): CAGRA's
    step loop, the children scored as ``cagra._search_chunk`` scores them."""
    from cuvs_tpu_torch.neighbors import cagra

    def score(parents, children):
        return cagra._distances_to((rows,), norms, queries, qnorm, children, metric,
                                   compute_dtype)

    state_v, state_id, _, counts = cagra._beam_loop(state_v, state_id, graph, score,
                                                    state_v.shape[1], search_width, max_iter,
                                                    vis_size)
    return state_v, state_id, counts
