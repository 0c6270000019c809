"""Sparse (CSR) brute force: the port against the JAX package on the CPU.

Every one of the 18 metrics, with blocks small enough that the per-block
merge runs (several query and index blocks) and feature tiles past the
data's last column, so the all-zero tile skip runs too. Distances rtol 1e-5
(atol 1e-6 for the values near 0), ids equal except at tied distances (the
reference's merge, argpartition + argsort, orders ties arbitrarily). The
port's on-device densify equals the reference's host ``_densify`` tile for
tile.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cuvs_tpu.neighbors import sparse_brute_force as jax_sbf
from cuvs_tpu_torch.neighbors import sparse_brute_force as sbf
from tests.torch_parity import ids_match_modulo_ties

torch.set_num_threads(1)

N_COLS = 300
ALL_METRICS = sorted(m.name for m in sbf._DOT_METRICS | sbf._POINTWISE_METRICS)


def _csr(seed, n, density=0.08, used_cols=220):
    """Positive values in the first ``used_cols`` columns of N_COLS."""
    m = sp.random(n, used_cols, density=density, random_state=np.random.RandomState(seed),
                  format="csr", dtype=np.float32)
    m.data += 0.05
    return sp.csr_matrix((m.data, m.indices, m.indptr), shape=(n, N_COLS))


@pytest.fixture(scope="module")
def data():
    return _csr(1, 700), _csr(2, 40)


def test_metric_sets_match_reference():
    assert {m.name for m in sbf._DOT_METRICS} == {m.name for m in jax_sbf._DOT_METRICS}
    assert ({m.name for m in sbf._POINTWISE_METRICS}
            == {m.name for m in jax_sbf._POINTWISE_METRICS})
    assert len(ALL_METRICS) == 18


@pytest.mark.parametrize("metric", ALL_METRICS)
def test_search_matches_reference(data, metric):
    x, q = data
    blocks = dict(query_block=16, index_block=256, feature_tile=64)
    jidx = jax_sbf.from_scipy(x, metric=metric)
    jd, ji = jax_sbf.search(jidx, q.indptr, q.indices, q.data, 7, **blocks)
    tidx = sbf.from_scipy(x, metric=metric, device="cpu")
    td, ti = sbf.search(tidx, q.indptr, q.indices, q.data, 7, **blocks)
    assert td.dtype == torch.float32 and ti.dtype == torch.int64
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-6)
    # InnerProduct ranks by -similarity
    order = -jd if metric == "InnerProduct" else jd
    ids_match_modulo_ties(ti.numpy(), ji, order, rtol=1e-5, atol=1e-6)


def test_fewer_rows_than_k_pads(data):
    x, q = data
    small = x[:5]
    jd, ji = jax_sbf.search(jax_sbf.from_scipy(small), q.indptr, q.indices, q.data, 8)
    td, ti = sbf.search(sbf.from_scipy(small, device="cpu"), q.indptr, q.indices, q.data, 8)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-6)
    assert np.isinf(td[:, 5:].numpy()).all()
    np.testing.assert_array_equal(ti[:, 5:].numpy(), 0)


def test_norms_match_reference(data):
    x, _ = data
    j = jax_sbf.from_scipy(x)
    t = sbf.from_scipy(x, device="cpu")
    np.testing.assert_allclose(t.norms.numpy(), j.norms, rtol=1e-6)
    assert t.size == j.size == 700


@pytest.mark.parametrize("r0,r1,lo,hi", [(0, 700, 0, 300), (13, 250, 64, 128),
                                        (600, 700, 256, 300), (5, 6, 0, 64)])
def test_device_densify_equals_reference_tiles(data, r0, r1, lo, hi):
    x, _ = data
    want = jax_sbf._densify(x.indptr, x.indices, x.data, np.arange(r0, r1), lo, hi)
    t = sbf.from_scipy(x, device="cpu")
    got = sbf._densify(sbf._block(t.indptr, t.indices, t.data, r0, r1), lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unsupported_metric_raises():
    with pytest.raises(ValueError):
        sbf.build(np.array([0, 1]), np.array([0]), np.array([1.0]), 3, metric="haversine",
                  device="cpu")
