"""Where the port's entry points put host data: on the card unless the caller
asks for the CPU, and never on the CPU by themselves."""

import numpy as np
import pytest
import torch

from cuvs_tpu_torch import interop
from cuvs_tpu_torch import mg
from cuvs_tpu_torch.cluster import agglomerative, kmeans, kmeans_balanced
from cuvs_tpu_torch.cluster import spectral as spectral_cluster
from cuvs_tpu_torch.core import bitpack, bitset
from cuvs_tpu_torch.distance import kernels, pairwise
from cuvs_tpu_torch.neighbors import (all_neighbors, ball_cover, brute_force, cagra,
                                      cross_component, epsilon_neighborhood, filters, graph_core,
                                      ivf_flat, ivf_pq, ivf_rabitq, ivf_sq, knn_graph, nn_descent,
                                      offload, refine, scann, sparse_brute_force, tiered_index,
                                      vamana)
from cuvs_tpu_torch.preprocessing import pca, quantize, spectral
from cuvs_tpu_torch.stats import silhouette_score, trustworthiness_score
from cuvs_tpu_torch.selection import select_k
from cuvs_tpu_torch.utils import device as dev_mod

torch.set_num_threads(1)

_X = np.random.default_rng(0).standard_normal((256, 16)).astype(np.float32)
# the exact 16-NN graph of _X without self: the graph functions' input
_G = np.argsort(((_X[:, None] - _X[None]) ** 2).sum(-1), 1, kind="stable")[:, 1:17].astype(np.int32)
_WORDS = np.random.default_rng(1).integers(0, 1 << 32, (256, 2), dtype=np.uint32)  # packed codes


def _like(x, a):
    """``a`` as the same kind of data as ``x``: a CPU tensor or a numpy array."""
    return torch.from_numpy(a) if isinstance(x, torch.Tensor) else a


def _csr(x):
    """The rows of x as CSR arrays (every entry stored), x's kind of data."""
    n, d = x.shape
    return (_like(x, np.arange(0, n * d + 1, d)), _like(x, np.tile(np.arange(d), n)),
            x.reshape(-1))


# entry point -> (call with the dataset and a device, the tensor its result lives in)
_ENTRIES = {
    "brute_force.build": lambda x, device: brute_force.build(x, device=device).dataset,
    "ivf_flat.build": lambda x, device: ivf_flat.build(x, n_lists=4, seed=0,
                                                       device=device).centers,
    "ivf_pq.build": lambda x, device: ivf_pq.build(x, n_lists=4, pq_dim=4, pq_bits=4, seed=0,
                                                   device=device).centers,
    "ivf_rabitq.build": lambda x, device: ivf_rabitq.build(x, n_lists=4, bits_per_dim=1, seed=0,
                                                           device=device).centers,
    "refine.refine": lambda x, device: refine.refine(
        x, x[:4], np.tile(np.arange(8, dtype=np.int32), (4, 1)), 2, device=device)[0],
    "ivf_sq.build": lambda x, device: ivf_sq.build(x, n_lists=4, seed=0, device=device).centers,
    "ivf_flat.build_streaming": lambda x, device: ivf_flat.build_streaming(
        lambda i: x, 1, n_lists=4, trainset_rows=256, device=device).centers,
    "refine.refine_host": lambda x, device: refine.refine_host(
        _X, x[:4], np.tile(np.arange(8, dtype=np.int32), (4, 1)), 2, device=device)[0],
    "quantize.scalar_train": lambda x, device: quantize.scalar_train(x, device=device).min_,
    "kmeans_balanced.fit": lambda x, device: kmeans_balanced.fit(x, 4, device=device),
    "kmeans_balanced.predict": lambda x, device: kmeans_balanced.predict(x, x[:4],
                                                                         device=device),
    "pairwise.pairwise_distance": lambda x, device: pairwise.pairwise_distance(
        x, x[:4], metric="l1", device=device),
    "graph_core.optimize": lambda x, device: graph_core.optimize(_like(x, _G), 8, device=device),
    "graph_core.connected_components": lambda x, device: graph_core.connected_components(
        _like(x, _G), device=device),
    "graph_core.augment_connectivity": lambda x, device: graph_core.augment_connectivity(
        _like(x, _G[:, :2]), dataset=x, device=device),
    "knn_graph.build_knn_graph": lambda x, device: knn_graph.build_knn_graph(
        x, 8, algo="brute_force", device=device)[0],
    "all_neighbors.build": lambda x, device: all_neighbors.build(
        x, 8, algo="brute_force", n_clusters=3, device=device)[0],
    "nn_descent.build": lambda x, device: nn_descent.build(
        x, graph_degree=8, intermediate_graph_degree=16, max_iterations=2, device=device)[0],
    "cagra.build": lambda x, device: cagra.build(
        x, intermediate_graph_degree=16, graph_degree=8, build_algo="brute_force",
        device=device).graph,
    "cagra.from_graph": lambda x, device: cagra.from_graph(x, _like(x, _G), device=device).graph,
    "select_k.select_k": lambda x, device: select_k.select_k(x, 4, device=device)[0],
    "select_k.merge_parts": lambda x, device: select_k.merge_parts(
        [x[:, :8], x[:, 8:]], [_like(x, _G[:, :8]), _like(x, _G[:, 8:])], 4, device=device)[1],
    "bitset.bitset_from_mask": lambda x, device: bitset.bitset_from_mask(x[:, 0] > 0,
                                                                         device=device),
    "bitset.bitmap_from_mask": lambda x, device: bitset.bitmap_from_mask(x > 0, device=device),
    "filters.from_mask": lambda x, device: filters.from_mask(x > 0, device=device).bits,
    "bitpack.pack": lambda x, device: bitpack.pack(x > 0, 1, device=device),
    "bitpack.unpack": lambda x, device: bitpack.unpack(_like(x, _WORDS), 4, 16, device=device),
    "cagra.build_ace": lambda x, device: cagra.build_ace(
        x, npartitions=2, intermediate_graph_degree=16, graph_degree=8, device=device).graph,
    "cagra.build_iterative": lambda x, device: cagra.build_iterative(
        x, graph_degree=8, intermediate_graph_degree=16, n_rounds=1, device=device).graph,
    "vamana.build": lambda x, device: vamana.build(x, graph_degree=8, visited_size=16,
                                                   device=device).graph,
    "scann.build": lambda x, device: scann.build(x, n_lists=4, pq_dim=4, pq_bits=4,
                                                 device=device).codes,
    "kmeans.fit": lambda x, device: kmeans.fit(x, n_clusters=4, max_iter=3, device=device)[0],
    "kmeans.predict": lambda x, device: kmeans.predict(x, x[:4], device=device),
    "kmeans.transform": lambda x, device: kmeans.transform(x, x[:4], device=device),
    "tiered_index.build": lambda x, device: tiered_index.build(
        brute_force, x, min_ann_rows=10**6, device=device).bf_data,
    "tiered_index.search": lambda x, device: tiered_index.search(
        tiered_index.build(brute_force, x, min_ann_rows=10**6, device=device), x[:4], 2)[0],
    "offload.build_host_refined": lambda x, device: offload.build_host_refined(
        x, "brute_force", device=device).device_index.dataset,
    "ball_cover.build": lambda x, device: ball_cover.build(x, n_landmarks=4,
                                                           device=device).radii,
    "epsilon_neighborhood.eps_neighbors": lambda x, device: epsilon_neighborhood.eps_neighbors(
        x, x[:4], 4.0, device=device)[0],
    "sparse_brute_force.build": lambda x, device: sparse_brute_force.build(
        *_csr(x), 16, device=device).norms,
    "sparse_brute_force.search": lambda x, device: sparse_brute_force.search(
        sparse_brute_force.build(*_csr(x), 16, device=device), *_csr(_X[:4]), 2)[1],
    "pca.fit": lambda x, device: pca.fit(x, 4, device=device).components,
    "spectral.spectral_embedding": lambda x, device: spectral.spectral_embedding(
        x, 2, n_neighbors=5, device=device),
    "spectral.spectral_embedding (LOBPCG)": lambda x, device: spectral.spectral_embedding(
        x, 2, n_neighbors=5, dense_threshold=100, device=device),
    "cluster.spectral.fit_predict": lambda x, device: spectral_cluster.fit_predict(
        x, 2, n_neighbors=5, device=device)[0],
    "stats.silhouette_score": lambda x, device: silhouette_score(
        x, np.arange(256) % 3, device=device),
    "stats.trustworthiness_score": lambda x, device: trustworthiness_score(
        x, _X[:, :2], 3, device=device),
    "kernels.gram_matrix": lambda x, device: kernels.gram_matrix(x, x[:4], device=device),
    "kernels.kde": lambda x, device: kernels.kde(x, x[:16], device=device),
}


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_host_data_goes_where_the_caller_says(entry):
    assert _ENTRIES[entry](_X, "cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_a_tensor_keeps_its_device(entry, no_cuda):
    # a CPU tensor with no device named stays on the CPU, even where the
    # default for host data is the card
    assert _ENTRIES[entry](torch.from_numpy(_X), None).device.type == "cpu"


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_host_data_without_a_device_needs_the_card(entry, no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRIES[entry](_X, None)


def test_bitset_create_goes_where_the_caller_says(no_cuda):
    assert bitset.bitset_create(64, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        bitset.bitset_create(64)


def test_device_helper_rules(no_cuda):
    t = torch.ones(3)
    assert dev_mod.as_tensor(t) is t
    assert dev_mod.as_tensor([1.0, 2.0], device="cpu").device.type == "cpu"
    assert dev_mod.as_tensor(t, device="cpu") is t
    assert dev_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dev_mod.resolve_device(None)


def test_interop_defaults_to_the_card(no_cuda):
    norms = (_X * _X).sum(1)
    idx = interop.brute_force_index_from_numpy(_X, norms, None, "sqeuclidean", device="cpu")
    assert idx.dataset.device.type == "cpu" and idx.norms.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.brute_force_index_from_numpy(_X, norms, None, "sqeuclidean")
    idx = interop.cagra_index_from_numpy(_X, norms, _G, "sqeuclidean", device="cpu")
    assert idx.dataset.device.type == "cpu" and idx.graph.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.cagra_index_from_numpy(_X, norms, _G, "sqeuclidean")


def test_interop_long_tail_defaults_to_the_card(no_cuda):
    p = interop.pca_from_numpy(_X.mean(0), _X[:4], np.ones(4, np.float32), device="cpu")
    assert p.components.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.pca_from_numpy(_X.mean(0), _X[:4], np.ones(4, np.float32))
    j = ivf_flat.build(_X, n_lists=4, seed=0, device="cpu")
    args = [a.numpy() for a in (j.centers, j.center_norms, j.sorted_data, j.sorted_norms,
                                j.lists.offsets, j.lists.sizes, j.lists.ids, j.lists.labels)]
    idx = interop.ball_cover_index_from_numpy(*args, None, "sqeuclidean", j.window, j.n_rows,
                                              np.ones(4, np.float32), device="cpu")
    assert idx.radii.device.type == "cpu" and idx.inner.sorted_data.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.ball_cover_index_from_numpy(*args, None, "sqeuclidean", j.window, j.n_rows,
                                            np.ones(4, np.float32))


@pytest.mark.parametrize("call", ["single_linkage", "cross_component_nn"])
def test_host_results_compute_on_the_card_by_default(no_cuda, call):
    """single_linkage and cross_component_nn return host arrays, as the
    reference does; their work runs on the card unless asked otherwise."""
    fn = {"single_linkage": lambda **kw: agglomerative.single_linkage(_X, 3, **kw).labels,
          "cross_component_nn": lambda **kw: cross_component.cross_component_nn(
              _X, np.arange(256) % 2, **kw)}[call]
    assert isinstance(fn(device="cpu"), np.ndarray)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()


def test_mg_entry_points_go_to_the_devices_named(no_cuda):
    """mg takes a list of devices (a device may repeat); with none named it
    takes every CUDA device, and raises without one."""
    idx = mg.build(_X, "brute_force", devices=["cpu"] * 3)
    assert [s.dataset.device.type for s in idx.shards] == ["cpu"] * 3
    assert mg.kmeans_fit(_X, 4, devices=["cpu"] * 2, max_iter=2)[0].device.type == "cpu"
    for call in (lambda: mg.build(_X, "brute_force"), lambda: mg.kmeans_fit(_X, 4),
                 lambda: mg.build(torch.from_numpy(_X), "brute_force"),
                 lambda: mg.default_devices()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_offload_builds_on_the_card_by_default(no_cuda):
    shards = offload.build(_X, "brute_force", n_shards=2, device="cpu").shards
    assert [s.dataset.device.type for s in shards] == ["cpu", "cpu"]
    with pytest.raises(RuntimeError, match="CUDA"):
        offload.build(_X, "brute_force", n_shards=2)
    idx = offload.build(_X, "brute_force", n_shards=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        offload.search(idx, _X[:2], 2)
