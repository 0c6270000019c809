"""The seeded stand-in of a dataset, made on the device.

The recipe of the embedding-like stand-in (low intrinsic dimension plus
noise: ``base = z @ P + noise * e`` with ``z`` of ``intrinsic_dim`` columns,
``P = randn(r, d) / sqrt(r)``), frozen here and run on the device from one
``torch.Generator`` seeded from ``--seed``, in a few large calls. With
``unit_norm`` the rows and the queries are scaled to length 1, as the
``-inner`` sets of ann-benchmarks are.
"""

from __future__ import annotations

import math

import torch

# rows drawn per call
_ROWS_PER_CALL = 1 << 21


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _rows(g, n, proj, noise, device):
    r, d = proj.shape
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for r0 in range(0, n, _ROWS_PER_CALL):
        m = min(_ROWS_PER_CALL, n - r0)
        z = torch.randn((m, r), generator=g, device=device)
        out[r0:r0 + m] = torch.addmm(
            torch.randn((m, d), generator=g, device=device), z, proj, beta=noise)
    return out


def make(spec: dict, seed: int, device):
    """(base [n_rows, dim], queries [n_queries, dim]) float32 on ``device``:
    the same seed and device give the same rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = generator(seed, device)
    n, d, nq, r = spec["n_rows"], spec["dim"], spec["n_queries"], spec["intrinsic_dim"]
    proj = torch.randn((r, d), generator=g, device=device) / math.sqrt(r)
    base = _rows(g, n, proj, spec["noise"], device)
    queries = _rows(g, nq, proj, spec["noise"], device)
    if spec.get("unit_norm"):
        base /= torch.linalg.vector_norm(base, dim=1, keepdim=True)
        queries /= torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    return base, queries
