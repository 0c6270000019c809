"""k-NN graph builds and all_neighbors: the port against the JAX package and
against exact k-NN, on the CPU.

Tolerances: the exact brute-force graph equals the reference's in ids modulo
ties and in distances to rtol 1e-5 / atol 1e-4; the batched build's merge,
given the reference's partition and per-cluster searches, is exactly equal.
The other builds draw other random numbers than the reference and are held to
tests/test_all_neighbors.py's recall floors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.cluster import kmeans_balanced as jax_kmeans
from cuvs_tpu.neighbors import all_neighbors as jax_an
from cuvs_tpu.neighbors import brute_force as jax_bf
from cuvs_tpu.neighbors import knn_graph as jax_knn
from cuvs_tpu_torch.neighbors import all_neighbors, knn_graph
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import naive_knn

torch.set_num_threads(1)

RNG = np.random.default_rng(101)


def _cloud(n, d, rng=RNG):
    return (rng.standard_normal((n, d)) * 2).astype(np.float32)


def _graph_recall(graph, x, k):
    _, gti = naive_knn(x, x, k + 1)
    gt = np.array([[j for j in row if j != i][:k] for i, row in enumerate(gti)])
    return np.mean([len(set(a) & set(b)) / k for a, b in zip(np.asarray(graph), gt)])


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_brute_force_graph_matches_reference(metric):
    x = _cloud(1500, 16)
    jg, jd = jax_knn.build_knn_graph(x, 10, metric=metric, algo="brute_force", query_batch=512)
    tg, td = knn_graph.build_knn_graph(torch.from_numpy(x), 10, metric=metric,
                                       algo="brute_force", query_batch=512)
    assert tg.dtype == torch.int32 and tg.shape == (1500, 10)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(tg.numpy(), np.asarray(jg), np.asarray(jd))


def test_knn_graph_exact():
    x = _cloud(2000, 16)
    nbrs, _ = knn_graph.build_knn_graph(x, 8, algo="brute_force", device="cpu")
    _, gti = naive_knn(x, x, 9)
    gt = np.array([[j for j in row if j != i][:8] for i, row in enumerate(gti)])
    assert (nbrs.numpy() == gt).mean() > 0.98
    assert not (nbrs.numpy() == np.arange(2000)[:, None]).any(), "self edges remain"


def test_drop_self_matches_reference():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 50, (50, 6)).astype(np.int32)
    ids[np.arange(50), rng.integers(0, 6, 50)] = np.arange(50)  # self somewhere in each row
    dists = np.sort(rng.random((50, 6)).astype(np.float32), 1)
    dists[:, 2] = dists[:, 1]  # ties
    ji, jd = jax_knn._drop_self(jnp.asarray(ids), jnp.asarray(dists), 5)
    ti, td = knn_graph._drop_self(torch.from_numpy(ids), torch.from_numpy(dists), 5)
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(td.numpy(),
                                                                         np.asarray(jd))


@pytest.mark.parametrize("algo,floor", [("ivf_pq", 0.9), ("partitioned", 0.9),
                                        ("nn_descent", 0.85)])
def test_other_algos_recall(algo, floor):
    x = _cloud(2000, 16)
    g, d = knn_graph.build_knn_graph(x, 8, algo=algo, seed=0, device="cpu")
    assert g.shape == (2000, 8) and g.dtype == torch.int32
    assert not (g.numpy() == np.arange(2000)[:, None]).any()
    assert _graph_recall(g.numpy(), x, 8) >= floor, algo
    with pytest.raises(ValueError):
        knn_graph.build_knn_graph(x[:100], 4, algo="spam", device="cpu")


def test_single_build():
    x = _cloud(3000, 16)
    g, _ = all_neighbors.build(x, 8, algo="brute_force", device="cpu")
    assert _graph_recall(g, x, 8) >= 0.99


def test_batched_build():
    x = _cloud(6000, 16)
    g, d = all_neighbors.build(x, 8, algo="brute_force", n_clusters=4, overlap_factor=2,
                               device="cpu")
    assert g.dtype == torch.int32 and (g.numpy() >= 0).all()
    assert _graph_recall(g, x, 8) >= 0.9


def test_batched_bad_overlap():
    with pytest.raises(ValueError):
        all_neighbors.AllNeighborsParams(n_clusters=2, overlap_factor=2)


def test_nn_descent_backend():
    x = _cloud(2000, 16)
    g, _ = all_neighbors.build(x, 8, algo="nn_descent", device="cpu")
    assert _graph_recall(g, x, 8) >= 0.85


def test_batched_merge_matches_reference(monkeypatch):
    """The reference's batched build with its centers and per-cluster
    self-searches recorded; the port's ``_merge`` fed the same searches and the
    reference's padded id maps (all_neighbors.py:118-177) gives exactly the
    reference's graph and distances."""
    x = _cloud(3000, 16)
    k, o = 8, 2
    centers, fit = [], jax_kmeans.fit
    searches, search = [], jax_bf.search

    def record_fit(*a, **kw):
        centers.append(fit(*a, **kw))
        return centers[-1]

    def record_search(*a, **kw):
        out = search(*a, **kw)
        searches.append(tuple(np.array(t) for t in out))
        return out

    monkeypatch.setattr(jax_kmeans, "fit", record_fit)
    monkeypatch.setattr(jax_bf, "search", record_search)
    jg, jd = jax_an.build(x, k, jax_an.AllNeighborsParams(algo="brute_force", n_clusters=4,
                                                          overlap_factor=o, seed=0))
    # the reference's partition, by its own formula
    c = centers[0]
    assign = np.asarray(jax.jit(lambda xf, c: jax.lax.top_k(
        -(jnp.sum(c * c, 1)[None, :] - 2.0 * xf @ c.T), o)[1])(jnp.asarray(x), c))
    members = [np.where((assign == ci).any(axis=1))[0] for ci in range(4)]
    M = -(-max(len(m) for m in members) // 128) * 128
    best_d = torch.full((3000, k), float("inf"))
    best_i = torch.full((3000, k), -1, dtype=torch.int32)
    replay = iter(searches)
    for m in members:
        padded = np.concatenate([m, np.full(M - len(m), m[0])]).astype(np.int32)
        sd, sl = next(replay)
        best_d, best_i = all_neighbors._merge(best_d, best_i, torch.from_numpy(padded),
                                              torch.from_numpy(sd), torch.from_numpy(sl),
                                              len(m), k)
    assert next(replay, None) is None
    # the reference pads short rows' ids with their first neighbour (:183-185);
    # the pad copies leave some rows here short
    first = torch.where(best_i[:, 0] >= 0, best_i[:, 0], torch.arange(1, 3001) % 3000)
    best_i = torch.where(best_i >= 0, best_i, first[:, None].to(torch.int32))
    assert np.array_equal(best_i.numpy(), np.asarray(jg))
    assert np.array_equal(best_d.numpy(), np.asarray(jd))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_batched_build_recall_matches_reference(compute):
    """The partitioned build as CAGRA's ``auto`` build runs it (overlap 2,
    exact per-cluster self-searches, bf16 operands or f32): the port's graph
    recalls the exact k-NN at least as well as the reference's, less 0.005.
    Its own partition and per-cluster sizes may differ from the reference's,
    so only recall is held."""
    rng = np.random.default_rng(17)
    x = (rng.standard_normal((5000, 8)) @ rng.standard_normal((8, 24))).astype(np.float32)
    k, c = 16, 8
    jg, _ = jax_an.build(x, k, jax_an.AllNeighborsParams(algo="brute_force", n_clusters=c,
                                                         overlap_factor=2, seed=0),
                         compute_dtype=getattr(jnp, compute))
    tg, td = all_neighbors.build(x, k, algo="brute_force", n_clusters=c, overlap_factor=2,
                                 seed=0, compute_dtype=getattr(torch, compute), device="cpu")
    want, got = _graph_recall(np.asarray(jg), x, k), _graph_recall(tg.numpy(), x, k)
    assert want >= 0.8  # the partition is not trivial: it loses neighbours
    assert got >= want - 0.005, (got, want)
    assert np.isfinite(td.numpy()).all()


def test_batched_build_is_exact_within_its_partition(monkeypatch):
    """In float32 each row's list is the exact k-NN over the members of its
    two clusters, so the graph's recall equals the share of exact neighbours
    that share a cluster with the row: the partition is the only loss."""
    x = _cloud(6000, 16, np.random.default_rng(5))
    k, parts = 16, []
    partition = all_neighbors._partition

    def record(*a, **kw):
        parts.append(partition(*a, **kw))
        return parts[-1]

    monkeypatch.setattr(all_neighbors, "_partition", record)
    g, _ = all_neighbors.build(x, k, algo="brute_force", n_clusters=8, overlap_factor=2,
                               device="cpu")
    assign, g = parts[0], g.numpy()
    rows = np.random.default_rng(3).permutation(len(x))[:200]
    ideal = []
    for i in rows:
        members = np.where(np.isin(assign, assign[i]).any(1))[0]
        d = ((x[members] - x[i]) ** 2).sum(1)
        d[members == i] = np.inf
        ideal.append(members[np.argsort(d, kind="stable")[:k]])
    assert _graph_recall(g, x, k) < 0.99  # the partition loses neighbours
    assert np.mean([len(set(a) & set(b)) / k for a, b in zip(g[rows], ideal)]) >= 0.998


def test_batched_build_rows_have_no_repeats():
    """Clusters of unequal size: the reference pads each to the largest with
    copies of its first member, which take neighbours' slots; the port
    searches each cluster at its own size, so every row holds k distinct
    non-self ids."""
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.standard_normal((n, 16)).astype(np.float32) + 30.0 * c
                        for c, n in enumerate((2500, 400, 900))])
    g, d = all_neighbors.build(x, 12, algo="brute_force", n_clusters=3, overlap_factor=2,
                               device="cpu")
    g = g.numpy()
    assert not (g == np.arange(len(x))[:, None]).any()
    s = np.sort(g, 1)
    assert not (s[:, 1:] == s[:, :-1]).any()
    assert np.isfinite(d.numpy()).all()
    assert _graph_recall(g, x, 12) >= 0.9
