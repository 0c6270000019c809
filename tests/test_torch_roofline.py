"""The bounds chip_smoke.py reports beside each kernel, computed from a call's
own shapes and data (the arithmetic only; the times need the card)."""

import numpy as np
import pytest
import torch

from cuvs_tpu_torch.bench import roofline
from cuvs_tpu_torch.ops import bf_topk


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
