"""The least time of a scan kernel's work on one NVIDIA H100, counted from the
problem and never from the kernel's arguments.

The counted inputs are the queries, the lists that each query's probes
select (worked out by the benchmark from the index's centers), the rows those
lists hold, ``d`` and the code width. Bytes: the rows or codes of every
probed list read once, the queries read once, the k results (a float and an
int32 id each) written once. Operations, as the port's first yardstick
counted them: 2 d per (query, row) pair for the IVF-Flat scan; for the PQ
scan 2 pq_dim per pair plus a lookup table of book x rot_dim multiply-adds
per (query, probe), all at the fp32 peak. The peaks are NVIDIA's H100 SXM
data sheet's (dense, at the full 700 W power limit): a card set lower is
named beside every share.
"""

from __future__ import annotations

import torch

# operations per second by type, and device-memory bytes per second
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# bytes of one result: a float32 distance and an int32 id
RESULT_BYTES = 8


def least_seconds(ops: float, peak: str, n_bytes: float) -> float:
    """The larger of the operations at their peak and the bytes at HBM rate."""
    return max(ops / PEAK[peak], n_bytes / HBM_BYTES_PER_S)


def probe_counts(probes: torch.Tensor, list_sizes: torch.Tensor) -> dict:
    """Counts of a batch whose queries search ``probes`` [nq, n_probes] over
    lists of ``list_sizes`` [n_lists] rows: the (query, row) pairs, the
    (query, probe) pairs, and the rows of the distinct probed lists."""
    sizes = list_sizes.long()
    probed = torch.zeros_like(sizes, dtype=torch.bool)
    probed[probes.reshape(-1).long()] = True
    return {"nq": int(probes.shape[0]),
            "pairs": int(sizes[probes.long()].sum()),
            "query_probes": int(probes.numel()),
            "probed_rows": int(sizes[probed].sum())}


def ivf_flat_scan(c: dict, d: int, k: int, row_bytes: int = 4) -> float:
    """Least seconds of the IVF-Flat scan of one batch (f32 rows: the fp32 peak)."""
    ops = 2.0 * d * c["pairs"]
    n_bytes = c["probed_rows"] * d * row_bytes + c["nq"] * d * 4 + c["nq"] * k * RESULT_BYTES
    return least_seconds(ops, "fp32", n_bytes)


def pq_scan(c: dict, d: int, pq_dim: int, pq_bits: int, k: int) -> float:
    """Least seconds of the PQ scan of one batch: a code of pq_bits per
    subspace, a table of 2^pq_bits entries per subspace built per (query,
    probe) over the rotated dimension pq_dim * ceil(d / pq_dim)."""
    rot_dim = pq_dim * -(-d // pq_dim)
    book = 1 << pq_bits
    ops = 2.0 * pq_dim * c["pairs"] + 2.0 * book * rot_dim * c["query_probes"]
    n_bytes = (c["probed_rows"] * pq_dim * pq_bits / 8 + c["nq"] * d * 4
               + c["nq"] * k * RESULT_BYTES)
    return least_seconds(ops, "fp32", n_bytes)
