"""The roofline's counts, held to a hand count on a 3-list index."""

import inspect

import pytest
import torch

from vsbench import roofline

# three lists of 5, 2 and 9 rows; two queries probing two lists each
SIZES = torch.tensor([5, 2, 9])
PROBES = torch.tensor([[0, 2], [2, 1]])


def test_probe_counts_by_hand():
    c = roofline.probe_counts(PROBES, SIZES)
    # pairs: (5 + 9) + (9 + 2); every list is probed: 16 rows
    assert c == {"nq": 2, "pairs": 25, "query_probes": 4, "probed_rows": 16}
    # a list probed by no query is not read
    assert roofline.probe_counts(torch.tensor([[0], [0]]), SIZES)["probed_rows"] == 5


def test_ivf_flat_scan_by_hand():
    c = roofline.probe_counts(PROBES, SIZES)
    ops = 2 * 96 * 25
    n_bytes = 16 * 96 * 4 + 2 * 96 * 4 + 2 * 10 * 8
    want = max(ops / 67e12, n_bytes / 3.35e12)
    assert roofline.ivf_flat_scan(c, 96, 10) == pytest.approx(want, rel=1e-12)


def test_pq_scan_by_hand():
    c = roofline.probe_counts(PROBES, SIZES)
    # 2 pq_dim per pair, a 256 x 128 table of multiply-adds per (query, probe)
    ops = 2 * 64 * 25 + 2 * 256 * 128 * 4
    n_bytes = 16 * 64 + 2 * 128 * 4 + 2 * 20 * 8
    want = max(ops / 67e12, n_bytes / 3.35e12)
    assert roofline.pq_scan(c, 128, 64, 8, 20) == pytest.approx(want, rel=1e-12)


def test_counts_read_the_problem_not_a_kernels_arguments():
    # the inputs are the probes, the list sizes and scalar widths: no tensor
    # that a kernel is handed (its padded windows, tiles or layouts)
    assert list(inspect.signature(roofline.probe_counts).parameters) == ["probes", "list_sizes"]
    for fn in (roofline.ivf_flat_scan, roofline.pq_scan):
        params = list(inspect.signature(fn).parameters)
        assert params[0] == "c" and all(p in ("d", "k", "pq_dim", "pq_bits", "row_bytes")
                                        for p in params[1:])
    src = inspect.getsource(roofline)
    assert "import cuvs_tpu_torch" not in src and "from cuvs_tpu_torch" not in src
