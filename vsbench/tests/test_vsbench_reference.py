"""The plain reference against numpy."""

import numpy as np
import pytest
import torch

from vsbench import reference


def _data(seed=0, n=700, d=24, nq=33):
    g = np.random.default_rng(seed)
    return g.standard_normal((n, d)).astype(np.float32), g.standard_normal((nq, d)).astype(np.float32)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_knn_matches_numpy_brute_force(metric, monkeypatch):
    x, q = _data()
    monkeypatch.setattr(reference, "BLOCK", 33 * 100)  # several row blocks
    d, i = reference.knn(torch.from_numpy(x), torch.from_numpy(q), 10, metric)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "inner_product":
        full = q64 @ x64.T
        want = np.argsort(-full, axis=1, kind="stable")[:, :10]
    else:
        full = ((q64[:, None, :] - x64[None]) ** 2).sum(2)
        want = np.argsort(full, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(full, want, 1), rtol=1e-5, atol=1e-4)


def test_distances_are_float64_exact():
    x, q = _data(1)
    ids = torch.randint(0, 700, (33, 5))
    d, scale = reference.distances(torch.from_numpy(x), torch.from_numpy(q), ids, "sqeuclidean")
    want = ((q.astype(np.float64)[:, None] - x.astype(np.float64)[ids.numpy()]) ** 2).sum(2)
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-12)
    assert d.dtype == torch.float64 and (scale > 0).all()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.0e-3])
    r = reference.round_tf32(x)
    assert r[0] == x[0]
    assert r[1] == 1.0  # a tie rounds to even
    assert r[2] == 1.0 + 2.0**-9
    assert ((r[3] - x[3]).abs() / x[3].abs()) <= 2.0**-11


def test_assignment_and_encoding_gaps():
    x, _ = _data(2, n=500, d=8)
    x = torch.from_numpy(x)
    centers = x[:12].clone()
    labels = reference.nearest_center(x, centers)
    assert reference.assign_gap(x, centers, labels) == 0.0
    wrong = labels.clone()
    wrong[3] = (wrong[3] + 1) % 12
    assert reference.assign_gap(x, centers, wrong) > 1e-3
    res = reference.residuals(x, centers, labels, torch.eye(8))
    books = torch.randn(4, 16, 2)
    codes = reference.encode(res.float(), books)
    assert reference.encode_gap(res, books, codes) < 1e-6
    codes[7, 2] = (codes[7, 2] + 8) % 16
    assert reference.encode_gap(res, books, codes) > 1e-3
