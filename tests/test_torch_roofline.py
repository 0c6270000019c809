"""The bounds chip_smoke.py reports beside each kernel, computed from a call's
own shapes and data (the arithmetic only; the times need the card)."""

import numpy as np
import pytest
import torch

from cuvs_tpu_torch.bench import roofline
from cuvs_tpu_torch.ops import bf_topk, ivf_scan


def test_bound_is_the_larger_of_operations_and_bytes():
    ops = roofline.bound(989e9, "bf16", 3.35e9)  # 1 ms of operations, 1 ms of bytes
    assert ops["bound_ms"] == pytest.approx(1.0)
    slow_bytes = roofline.bound(989e9, "bf16", 6.7e9)
    assert slow_bytes == {"bound_ms": pytest.approx(2.0), "bound_by": "bytes"}
    assert roofline.bound(67e12 * 3, "fp32", 0)["bound_by"] == "operations"


@pytest.mark.parametrize("dtype,peak", [(torch.float32, "fp32"), (torch.bfloat16, "bf16"),
                                        (torch.int8, "int8")])
def test_brute_force_bound_counts_products_and_bytes(dtype, peak):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(-5, 5, (64, 32))).to(dtype)
    x = torch.from_numpy(rng.integers(-5, 5, (3000, 32))).to(dtype)
    qn, dn = (t.float().pow(2).sum(1) for t in (q, x))
    args = (q, x, qn, dn, 10, 1024, False)
    out = bf_topk.bf_topk_exact(*args)
    got = roofline.kernel_bound("bf_topk_exact", args, {}, out)
    n_bytes = sum(t.numel() * t.element_size() for t in (q, x, qn, dn, *out))
    want = max(2.0 * 64 * 3000 * 32 / roofline.PEAK[peak], n_bytes / roofline.HBM_BYTES_PER_S)
    assert got["bound_ms"] == pytest.approx(want * 1e3)


def test_scan_pairs_count_valid_slots_and_list_rows():
    qidx = torch.tensor([[0, 1, -1], [-1, -1, -1], [2, -1, -1]], dtype=torch.int32)
    lo = torch.tensor([0, 0, 200], dtype=torch.int32)
    sizes = torch.tensor([100, 50, 300], dtype=torch.int32)
    # tile 0: 2 slots x 100 rows; tile 1: no slot; tile 2: 1 slot x (256 - 200) rows
    assert roofline._scan_pairs(qidx, lo, sizes, 256) == 2 * 100 + 56


@pytest.mark.parametrize("dtype,qdtype,peak", [(torch.float32, torch.float32, "fp32"),
                                               (torch.bfloat16, torch.float32, "fp32"),
                                               (torch.bfloat16, torch.bfloat16, "bf16")])
def test_scan_bound_takes_the_products_type(dtype, qdtype, peak, monkeypatch):
    monkeypatch.setattr(roofline, "HBM_BYTES_PER_S", 1e30)  # the operations bound it
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1024, 32)).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32)).to(qdtype)
    norms = x.float().pow(2).sum(1)
    qidx = torch.tensor([[0, 1, -1, 3], [4, -1, -1, -1]], dtype=torch.int32)
    tiles = [torch.tensor(v, dtype=torch.int32) for v in ([0, 256], [5, 0], [300, 128])]
    args = (x, norms, q, qidx, *tiles, 1.0)
    kw = dict(W=512, m_tile=4, ip=False, int8_mode=False, cap=2)
    out = ivf_scan.fused_ivf_scan(*args, **kw)
    got = roofline.kernel_bound("ivf_scan", args, kw, out)
    ops = 2.0 * (3 * 300 + 1 * 128) * 32
    assert got == {"bound_ms": pytest.approx(ops / roofline.PEAK[peak] * 1e3),
                   "bound_by": "operations"}


@pytest.mark.parametrize("offsets", [False, True])
def test_pool_topk_bound_reads_each_kept_pair_row_once(offsets):
    from cuvs_tpu_torch.ops import pool_topk
    from torch_parity import pool_case

    case = pool_case(5, 6, 4, 256, offsets=offsets, dropped=0.3)
    args = tuple(None if case[k] is None else torch.from_numpy(case[k])
                 for k in ("out_v", "pair_tile", "pair_slot", "offs")) + (20,)
    out = pool_topk.pool_topk(*args)
    got = roofline.kernel_bound("pool_topk", args, {}, out)
    kept = int((case["pair_tile"] < case["out_v"].shape[0]).sum())
    assert 0 < kept < 6 * 4
    # rows of the dropped pairs and the pool's unused slots are not read
    n_bytes = kept * 256 * 4 + 2 * 6 * 4 * 4 + (6 * 4 * 4 if offsets else 0) + 6 * 20 * (4 + 8)
    assert got == {"bound_ms": pytest.approx(n_bytes / roofline.HBM_BYTES_PER_S * 1e3),
                   "bound_by": "bytes"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cagra_beam_bound_reads_what_the_walk_counts(dtype):
    """Each expanded parent's graph row and each scored child's row and norm,
    once: the counts the walk returns, not the whole graph or dataset."""
    from cuvs_tpu_torch.distance.pairwise import DistanceType
    from cuvs_tpu_torch.ops import cagra_beam

    g = torch.Generator().manual_seed(3)
    n, d, deg, B, L = 200, 24, 6, 5, 16
    rows = torch.randn(n, d, generator=g).to(dtype)
    norms = rows.float().pow(2).sum(1)
    graph = torch.randint(0, n, (n, deg), generator=g, dtype=torch.int32)
    q = torch.randn(B, d, generator=g)
    qn = q.pow(2).sum(1)
    ids = torch.stack([torch.randperm(n, generator=g)[:L] for _ in range(B)]).to(torch.int32)
    v, order = torch.sort(((rows.float()[ids.long()] - q[:, None]) ** 2).sum(2), 1)
    ids = torch.gather(ids, 1, order)
    args = (rows, norms, graph, q, qn, v, ids, 1, 30, 32, DistanceType.L2Expanded, torch.float32)
    out = cagra_beam.beam_search(*args)
    steps, parents, scored = (int(c) for c in out[2].sum(0))
    assert 0 < steps == parents and 0 < scored < parents * deg
    n_bytes = (parents * deg * 4 + scored * (d * rows.element_size() + 4)
               + B * d * 4 + B * 4 + 2 * 2 * B * L * 4 + B * 3 * 4)
    got = roofline.kernel_bound("cagra_beam", args, {}, out)
    assert got == {"bound_ms": pytest.approx(n_bytes / roofline.HBM_BYTES_PER_S * 1e3),
                   "bound_by": "bytes"}
