"""HNSW interop: the port against the JAX package on the CPU, and the port's
own files (tests/test_graph_family.py's hnsw tests).

For the same CAGRA index the hnswlib files are byte-identical to the
reference's, base layer only ("none") and with host-linked levels ("cpu",
whose levels both packages draw from ``np.random.default_rng(seed)``). The
device hierarchy ("tpu" / "gpu", here on the CPU) draws the same levels and
links each level by exact brute force: the same links but at distance ties.
Each package reads the other's files.
"""

import filecmp

import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import cagra as jax_cagra
from cuvs_tpu.neighbors import hnsw as jax_hnsw
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import cagra, hnsw
from tests.utils import calc_recall, naive_knn

torch.set_num_threads(1)


def _cloud(rng, n, d):
    return (rng.standard_normal((n, d)) * 2).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """A reference CAGRA index of odd degree (links padded to an even maxM0)
    and the same index in the port."""
    x = _cloud(np.random.default_rng(83), 2000, 16)
    j = jax_cagra.build(x, intermediate_graph_degree=32, graph_degree=17, seed=0)
    t = interop.cagra_index_from_numpy(np.asarray(j.dataset), np.asarray(j.dataset_norms),
                                       np.asarray(j.graph), j.metric, device="cpu")
    return x, j, t


@pytest.mark.parametrize("hierarchy", ["none", "cpu"])
def test_files_match_reference_bytes(carried, tmp_path, hierarchy):
    x, j, t = carried
    ref, own = str(tmp_path / "ref.hnsw"), str(tmp_path / "own.hnsw")
    jax_hnsw.from_cagra(j, ref, jax_hnsw.HnswParams(hierarchy=hierarchy, seed=3))
    hnsw.from_cagra(t, own, hnsw.HnswParams(hierarchy=hierarchy, seed=3))
    assert filecmp.cmp(ref, own, shallow=False)
    levels, maxlevel, enter, links = hnsw.read_hierarchy(ref)
    rl, rmax, rent, rlinks = jax_hnsw.read_hierarchy(own)
    assert np.array_equal(levels, rl) and (maxlevel, enter) == (rmax, rent)
    assert links.keys() == rlinks.keys()
    assert all(np.array_equal(links[key], rlinks[key]) for key in links)
    if hierarchy == "cpu":
        assert maxlevel >= 1 and len(links) > 0


def test_device_hierarchy_matches_reference_but_at_ties(carried, tmp_path):
    x, j, t = carried
    ref, own = str(tmp_path / "ref.hnsw"), str(tmp_path / "own.hnsw")
    jax_hnsw.from_cagra(j, ref, jax_hnsw.HnswParams(hierarchy="tpu", seed=1))
    hnsw.from_cagra(t, own, hnsw.HnswParams(hierarchy="gpu", seed=1))
    lr, mr, er, linkr = jax_hnsw.read_hierarchy(ref)
    lt, mt, et, linkt = hnsw.read_hierarchy(own)
    assert np.array_equal(lr, lt) and (mr, er) == (mt, et) and linkr.keys() == linkt.keys()
    for (node, lvl), ln in linkt.items():
        ref_ln = linkr[(node, lvl)]
        if not np.array_equal(ln, ref_ln):  # only a reordering of equally distant links
            d = lambda ids: ((x[ids] - x[node]) ** 2).sum(1)  # noqa: E731
            np.testing.assert_allclose(np.sort(d(ln)), np.sort(d(ref_ln)), rtol=1e-5)


def test_level_knn_device_matches_host(carried):
    x, _, _ = carried
    sub = x[:300]
    host = hnsw._level_knn_host(sub, 8)
    dev = hnsw._level_knn_device(sub, 8, "sqeuclidean", device="cpu")
    assert dev.shape == host.shape and (dev != np.arange(300)[:, None]).all()
    assert (dev == host).mean() >= 0.99


def test_load_reads_reference_files(carried, tmp_path):
    x, j, t = carried
    ref = str(tmp_path / "ref.hnsw")
    jax_hnsw.from_cagra(j, ref)
    loaded = hnsw.load(ref, device="cpu")
    assert torch.equal(loaded.graph, t.graph) and torch.equal(loaded.dataset, t.dataset)
    q = torch.from_numpy(_cloud(np.random.default_rng(2), 20, 16))
    d, i = hnsw.search(loaded, q, 5, ef=48, seed=4)
    d2, i2 = cagra.search(cagra.from_graph(t.dataset, t.graph), q, 5, itopk_size=48, seed=4)
    assert torch.equal(i, i2) and torch.equal(d, d2)


# --- the port's own files, held to tests/test_graph_family.py's checks ---


def test_hnsw_roundtrip(tmp_path):
    rng = np.random.default_rng(84)
    x, q = _cloud(rng, 2000, 16), _cloud(rng, 20, 16)
    idx = cagra.build(x, intermediate_graph_degree=32, graph_degree=17, seed=0, device="cpu")
    p = str(tmp_path / "index.hnsw")
    hnsw.from_cagra(idx, p)
    loaded = hnsw.load(p, device="cpu")
    assert loaded.size == 2000 and loaded.dim == 16
    assert torch.equal(loaded.graph, idx.graph)
    np.testing.assert_allclose(loaded.dataset.numpy(), x, rtol=1e-6)
    _, i = hnsw.search(loaded, q, 5, ef=64)
    _, gti = naive_knn(q, x, 5)
    assert calc_recall(i.numpy(), gti) >= 0.9


def test_hnsw_cpu_hierarchy(tmp_path):
    x = _cloud(np.random.default_rng(85), 3000, 16)
    idx = cagra.build(x, intermediate_graph_degree=32, graph_degree=16, seed=0, device="cpu")
    p = str(tmp_path / "h.hnsw")
    hnsw.from_cagra(idx, p, hnsw.HnswParams(hierarchy="cpu", seed=0))
    levels, maxlevel, enterpoint, links = hnsw.read_hierarchy(p)
    assert maxlevel >= 1 and levels[enterpoint] == maxlevel
    assert 0 < int((levels >= 1).sum()) < 3000
    for (node, lvl), ln in links.items():
        assert levels[node] >= lvl and len(ln) > 0
        assert (levels[ln] >= lvl).all()
    assert torch.equal(hnsw.load(p, device="cpu").graph, idx.graph)


def test_hnsw_tpu_hierarchy(tmp_path):
    x = _cloud(np.random.default_rng(86), 1500, 16)
    idx = cagra.build(x, intermediate_graph_degree=32, graph_degree=16, seed=0, device="cpu")
    pc, pt = str(tmp_path / "c.hnsw"), str(tmp_path / "t.hnsw")
    hnsw.from_cagra(idx, pc, hnsw.HnswParams(hierarchy="cpu", seed=0))
    hnsw.from_cagra(idx, pt, hnsw.HnswParams(hierarchy="tpu", seed=0))
    lc, mlc, epc, linkc = hnsw.read_hierarchy(pc)
    lt, mlt, ept, linkt = hnsw.read_hierarchy(pt)
    assert np.array_equal(lc, lt) and (mlc, epc) == (mlt, ept) and linkc.keys() == linkt.keys()
    overlap = [len(set(linkc[k].tolist()) & set(linkt[k].tolist())) / len(linkc[k])
               for k in linkc]
    assert np.mean(overlap) >= 0.95
    for (node, lvl), ln in linkt.items():
        assert lt[ln].min() >= lvl


def test_hnsw_header_fields(tmp_path):
    import struct

    x = _cloud(np.random.default_rng(87), 100, 8)
    idx = cagra.build(x, intermediate_graph_degree=16, graph_degree=8, seed=0, device="cpu")
    p = str(tmp_path / "i.hnsw")
    hnsw.from_cagra(idx, p)
    with open(p, "rb") as f:
        raw = f.read(96)
    offset0, max_el, count, spe, label_off, data_off = struct.unpack("<6Q", raw[:48])
    assert offset0 == 0 and max_el == 100 and count == 100
    assert struct.unpack("<2i", raw[48:56]) == (1, 50)
    maxm, maxm0, m = struct.unpack("<3Q", raw[56:80])
    assert maxm0 == 8 and m == 4
    assert spe == 36 + 32 + 8
    with pytest.raises(NotImplementedError, match="hierarchy"):
        hnsw.from_cagra(idx, p, hnsw.HnswParams(hierarchy="spam"))
