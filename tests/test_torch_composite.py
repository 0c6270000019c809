"""The composite index (a logical merge) and CAGRA's merge: the port against
the JAX package on the CPU, and the port's own merges against exact k-NN.

Over brute-force children the composite search is exact, so the port's
top-k equals the reference's: distances to rtol 1e-5, ids equal except at
ties (within rtol 1e-5 / atol 1e-4). Each child reads the shared prefilter
in its own local ids, as in the reference (composite.py:36-40).
"""

import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import brute_force as jax_bf
from cuvs_tpu.neighbors import composite as jax_composite
from cuvs_tpu.neighbors import filters as jax_filters
from cuvs_tpu_torch.neighbors import brute_force, cagra, composite, filters
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, make_blobs, naive_knn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    return make_blobs(rng, 3000, 16), make_blobs(rng, 20, 16)


def _halves(module, x, cut, **kw):
    return [module.build(x[:cut], **kw), module.build(x[cut:], **kw)]


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_composite_search_matches_reference(data, metric):
    x, q = data
    jc = jax_composite.merge(jax_bf, _halves(jax_bf, x, 1000, metric=metric), strategy="logical")
    xt = torch.from_numpy(x)
    tc = composite.merge(brute_force, _halves(brute_force, xt, 1000, metric=metric),
                         strategy="logical")
    assert tc.size == jc.size == 3000
    jd, ji = jc.search(q, 10)
    td, ti = tc.search(torch.from_numpy(q), 10)
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)


def test_composite_prefilter_is_read_in_child_local_ids(data):
    """Every child gets the same filter and reads bit j as its own row j: a
    filter over global ids must be cut per child by the caller. The port
    mirrors the reference."""
    x, q = data
    keep = np.random.default_rng(1).random(2000) > 0.5  # covers the larger child's rows
    jc = jax_composite.merge(jax_bf, _halves(jax_bf, x, 1000), strategy="logical")
    tc = composite.merge(brute_force, _halves(brute_force, torch.from_numpy(x), 1000),
                         strategy="logical")
    jd, ji = jc.search(q, 10, prefilter=jax_filters.from_mask(keep))
    td, ti = tc.search(torch.from_numpy(q), 10, prefilter=filters.from_mask(keep, device="cpu"))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)
    ids = ti.numpy()
    local = np.where(ids < 1000, ids, ids - 1000)
    assert keep[local].all()


def test_composite_merge(data):
    """tests/test_extras.py::test_composite_merge."""
    x, q = data
    xt = torch.from_numpy(x)
    a, b = _halves(brute_force, xt, 1000)
    comp = composite.merge(brute_force, [a, b], strategy="logical")
    assert comp.size == 3000
    d, i = comp.search(torch.from_numpy(q), 10)
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.999
    phys = composite.merge(brute_force, [a, b], datasets=[x[:1000], x[1000:]],
                           strategy="physical", device="cpu")
    assert phys.dataset.device.type == "cpu" and phys.size == 3000
    _, i2 = brute_force.search(phys, torch.from_numpy(q), 10)
    assert calc_recall(i2.numpy(), gti) >= 0.999


def test_composite_id_offsets_and_bad_strategies(data):
    x, q = data
    xt = torch.from_numpy(x)
    a = brute_force.build(xt[:1000])
    # two children with global ids already: offsets 0 and 0 return the same ids twice
    comp = composite.merge(brute_force, [a, a], id_offsets=[0, 0])
    _, i = comp.search(torch.from_numpy(q), 4)
    assert (i.numpy() < 1000).all()
    with pytest.raises(ValueError, match="strategy"):
        composite.merge(brute_force, [a], strategy="spam")
    with pytest.raises(ValueError, match="datasets"):
        composite.merge(brute_force, [a], strategy="physical")
    with pytest.raises(ValueError, match="at least one child"):
        composite.CompositeIndex([])


@pytest.mark.parametrize("strategy", ["logical", "physical"])
def test_cagra_merge(data, strategy):
    x, q = data
    xt = torch.from_numpy(x)
    small = dict(intermediate_graph_degree=32, graph_degree=16, seed=0)
    merged = cagra.merge(_halves(cagra, xt, 1500, **small), strategy=strategy,
                         params=cagra.IndexParams(**small) if strategy == "physical" else None)
    assert merged.size == 3000
    if strategy == "logical":
        assert isinstance(merged, composite.CompositeIndex)
        d, i = merged.search(torch.from_numpy(q), 10, itopk_size=64)
    else:
        assert isinstance(merged, cagra.Index) and merged.graph.shape == (3000, 16)
        d, i = cagra.search(merged, torch.from_numpy(q), 10, itopk_size=64)
    gtd, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti, d.numpy(), gtd) >= 0.9
