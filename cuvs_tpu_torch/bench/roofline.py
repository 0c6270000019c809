"""Least times and yardsticks of the port's kernels on one NVIDIA H100.

``bound_ms`` is the least time the card could take for a kernel's work: the
larger of its bytes (each input read once, each output written once) over
the memory rate and its operations over the peak rate of their type
(NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit).
Operations are counted from the call's own data: the valid (query, row)
pairs of a scan, not its padded windows. ``product_ms`` times the cuBLAS
product of a brute-force call's operands alone, the yardstick of its
mainloop; no kernel calls it.
"""

from __future__ import annotations

import torch

# operations per second by type, and device-memory bytes per second
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
_PEAK_OF = {torch.bfloat16: "bf16", torch.int8: "int8", torch.float32: "fp32"}
# cap on one chunk's product output, as the brute-force yardstick is chunked
_PRODUCT_OUT_BYTES = 4 << 30


def nbytes(*objs) -> int:
    return sum(t.numel() * t.element_size() for t in objs if isinstance(t, torch.Tensor))


def bound(ops: float, peak: str, n_bytes: float) -> dict:
    """{"bound_ms", "bound_by"} for ops of type ``peak`` and n_bytes moved."""
    t_ops = ops / PEAK[peak] * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _scan_pairs(qidx, lo, sizes, W: int) -> float:
    """Valid (query slot, list row) pairs of a fused IVF scan."""
    slots = (qidx >= 0).sum(dim=1).double()
    rows = torch.clamp(torch.minimum(sizes.long(), W - lo.long()), min=0).double()
    return float((slots * rows).sum())


def kernel_bound(name: str, args, kw, out) -> dict:
    """bound_ms / bound_by of one recorded wrapper call (chip_smoke.kernels())."""
    n_bytes = nbytes(*args, *kw.values(), *out)
    if name in ("bf_topk_exact", "bf_topk_approx"):
        q, x = args[0], args[1]
        ops = 2.0 * q.shape[0] * x.shape[0] * q.shape[1]
        return bound(ops, _PEAK_OF[q.dtype], n_bytes)
    if name == "ivf_scan":
        rows, queries, qidx, _, lo, sizes = args[0], args[2], args[3], args[4], args[5], args[6]
        ops = 2.0 * _scan_pairs(qidx, lo, sizes, kw["W"]) * rows.shape[1]
        # a float32 operand (f32 rows, or f32 queries of bf16 rows) puts the
        # products on the fp32 tile
        fp32 = torch.float32 in (rows.dtype, queries.dtype)
        return bound(ops, "fp32" if fp32 else _PEAK_OF[rows.dtype], n_bytes)
    if name == "pq_scan":
        queries, cb_t, qidx, lo, sizes = args[2], args[3], args[5], args[7], args[8]
        book = kw.get("book", 256)
        S = cb_t.shape[1] // book
        # per pair one table read and one add per code; per slot its table
        # (book x dp multiply-adds)
        ops = (2.0 * S * _scan_pairs(qidx, lo, sizes, kw["W"])
               + 2.0 * float((qidx >= 0).sum()) * book * queries.shape[1])
        return bound(ops, "fp32", n_bytes)
    if name == "pool_topk":
        # a selection: each kept pair's pool row read once (not the whole
        # pool), the pair tables and offsets, the outputs; no arithmetic to bound
        out_v, pair_tile = args[0], args[1]
        rows = float((pair_tile < out_v.shape[0]).sum())
        return bound(0.0, "fp32", rows * out_v.shape[2] * 4 + nbytes(*args[1:4], *out))
    if name == "cagra_beam":
        # a walk over the graph: each expanded parent's graph row and each
        # scored child's row and norm read once, as the walk counts them
        # (``out``'s counts [B, 3]: steps, parents, scored children), the
        # queries, their norms and the lists in and out; 2 d operations a
        # scored child
        rows, graph = args[0], args[2]
        _, parents, scored = (float(c) for c in out[2].double().sum(0))
        d = rows.shape[1]
        n_bytes = (parents * graph.shape[1] * graph.element_size()
                   + scored * (d * rows.element_size() + 4) + nbytes(*args[3:7], *out))
        return bound(2.0 * scored * d, "fp32", n_bytes)
    raise KeyError(name)


def product_ms(q: torch.Tensor, x: torch.Tensor) -> float:
    """CUDA-event time of the cuBLAS product q @ x.T alone (bf16 ``torch.mm``,
    int8 ``torch._int_mm``, fp32 ``torch.mm`` with TF32 off), in query chunks
    whose output stays under 4 GiB, summed over the chunks; warmed up first."""
    out_size = 4 if q.dtype in (torch.int8, torch.float32) else 2
    rows = max(32, min(q.shape[0], _PRODUCT_OUT_BYTES // (out_size * x.shape[0])) // 32 * 32)
    xt = x.t()

    def mm(c):
        if q.dtype == torch.int8:
            return torch._int_mm(c, xt)
        return torch.mm(c, xt)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        chunks = [q[r0:r0 + rows] for r0 in range(0, q.shape[0], rows)]
        mm(chunks[0])
        total = 0.0
        for c in chunks:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = mm(c)
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
            del out
        return total
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
