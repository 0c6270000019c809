"""NN-descent: the port against the JAX package and against exact k-NN, on
the CPU.

One expansion round, fed the reference's own random picks, gives the same
graph in ids modulo ties (distances rtol 1e-5 / atol 1e-4) and the same count
of changed slots within the number of tied slots. Whole builds draw other
random numbers than the reference and are held to
tests/test_graph_family.py's recall floors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import graph_core as jax_gc
from cuvs_tpu.neighbors import nn_descent as jax_nnd
from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.neighbors import cagra, graph_core, nn_descent
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import calc_recall, naive_knn

torch.set_num_threads(1)

RNG = np.random.default_rng(83)


def _cloud(n, d, rng=RNG):
    return (rng.standard_normal((n, d)) * 2).astype(np.float32)


def _knn_recall(graph, x, k):
    _, gti = naive_knn(x, x, k + 1)
    gt = np.array([[j for j in row if j != i][:k] for i, row in enumerate(gti)])
    return np.mean([len(set(a) & set(b)) / k for a, b in zip(np.asarray(graph), gt)])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_expand_round_matches_reference_with_its_picks(compute):
    n, d, K, S, chunk = 1024, 16, 16, 256, 256
    rng = np.random.default_rng(7)
    x = _cloud(n, d, rng)
    # a rank-sorted random graph of distinct non-self ids and its distances
    g = np.stack([rng.choice(np.delete(np.arange(n), i), K, replace=False) for i in range(n)])
    gd = ((x[:, None, :] - x[g]) ** 2).sum(-1).astype(np.float32)
    order = np.argsort(gd, 1, kind="stable")
    g = np.take_along_axis(g, order, 1).astype(np.int32)
    gd = np.take_along_axis(gd, order, 1)
    rev, valid = jax_gc._reverse_graph(g, K)
    adj = np.array(jnp.concatenate([g, jnp.where(valid, rev, jnp.arange(n)[:, None])], 1),
                   np.int32)
    norms = (x * x).sum(1)
    key = jax.random.PRNGKey(3)
    ji, jd, jch = jax_nnd._expand_round(key, x, norms, g, gd, adj, K, S, chunk,
                                        getattr(jnp, compute))
    # the reference's per-chunk picks (nn_descent.py:77, 111)
    keys = jax.random.split(key, n // chunk)
    picks = [np.array(jax.random.randint(keys[c], (chunk, S), 0, 4 * K * K))
             for c in range(n // chunk)]
    ti, td, tch = nn_descent._expand_round(
        torch.from_numpy(x), pairwise.row_norms(torch.from_numpy(x)), torch.from_numpy(g),
        torch.from_numpy(gd), torch.from_numpy(adj),
        lambda row0, B: torch.from_numpy(picks[row0 // chunk]), chunk, getattr(torch, compute))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd))
    tied = int((ti.numpy() != np.asarray(ji)).sum())
    assert abs(tch - float(jch)) <= tied


def test_nn_descent_graph_quality():
    x = _cloud(2000, 24)
    graph, dists = nn_descent.build(x, graph_degree=16, intermediate_graph_degree=32,
                                    max_iterations=8, seed=0, device="cpu")
    assert graph.shape == (2000, 16) and graph.dtype == torch.int32
    assert _knn_recall(graph.numpy(), x, 16) >= 0.85
    sel = ((x[:5, None, :] - x[graph.numpy()[:5]]) ** 2).sum(-1)
    np.testing.assert_allclose(dists.numpy()[:5], sel, rtol=1e-2, atol=1e-2)


def test_nn_descent_block_local():
    x = _cloud(3000, 24)
    graph, _ = nn_descent.build(x, graph_degree=16, intermediate_graph_degree=32, seed=0,
                                block_local=True, device="cpu")
    assert graph.shape == (3000, 16) and graph.dtype == torch.int32
    assert _knn_recall(graph.numpy(), x, 16) >= 0.85
    assert not np.any(graph.numpy() == np.arange(3000)[:, None])  # no self-loops


def test_nn_descent_feeds_cagra():
    x = _cloud(2000, 16)
    q = _cloud(50, 16)
    graph, _ = nn_descent.build(x, graph_degree=24, intermediate_graph_degree=32,
                                max_iterations=8, seed=0, device="cpu")
    idx = cagra.from_graph(x, graph_core.optimize(graph, 16), device="cpu")
    _, i = cagra.search(idx, q, 10, itopk_size=64)
    _, gti = naive_knn(q, x, 10)
    assert calc_recall(i.numpy(), gti) >= 0.85
