"""Index files (``utils.serialize``) between the port and the JAX package, on
the CPU: the same ``.npz`` format both ways.

A file the JAX package wrote loads in the port and searches bit-identically
to the same index carried across in memory (``interop``); the port's own
files round-trip bit for bit, bfloat16 storage included; the JAX package
loads the port's brute-force, IVF-Flat (non-bf16) and IVF-SQ files and its
searches agree with the port's to rtol 1e-5 / atol 1e-4, ids equal except at
ties; it loads the port's files of the three CAGRA kinds (raw, VPQ, packed)
with the same arrays. Bad headers are refused as the reference refuses them.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import brute_force as jax_bf
from cuvs_tpu.neighbors import cagra as jax_cagra
from cuvs_tpu.neighbors import ivf_flat as jax_flat
from cuvs_tpu.neighbors import ivf_pq as jax_pq
from cuvs_tpu.neighbors import ivf_rabitq as jax_rq
from cuvs_tpu.neighbors import ivf_sq as jax_sq
from cuvs_tpu.utils import serialize as jax_serialize
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq, ivf_rabitq, ivf_sq
from cuvs_tpu_torch.utils import serialize
from tests.torch_parity import ids_match_modulo_ties
from tests.utils import make_blobs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(71)
    return make_blobs(rng, 1500, 24), make_blobs(rng, 12, 24)


def _lists(j):
    return (j.lists.offsets, j.lists.sizes, j.lists.ids, j.lists.labels)


# kind -> (JAX build, carry across, port search)
_KINDS = {
    "brute_force": (
        lambda x: jax_bf.build(x, metric="euclidean"),
        lambda j: interop.brute_force_index_from_numpy(j.dataset, j.norms, j.q_scale, j.metric,
                                                       device="cpu"),
        lambda t, q: brute_force.search(t, q, 5)),
    "ivf_flat_bf16": (
        lambda x: jax_flat.build(x, n_lists=8, seed=0, storage_dtype=jnp.bfloat16),
        lambda j: interop.ivf_flat_index_from_numpy(
            j.centers, j.center_norms, j.sorted_data, j.sorted_norms, *_lists(j), j.q_scale,
            j.metric, j.window, j.n_rows, device="cpu"),
        lambda t, q: ivf_flat.search(t, q, 5, n_probes=4, scan_algo="fused")),
    "ivf_flat_int8": (
        lambda x: jax_flat.build(x, n_lists=8, seed=0, storage_dtype=jnp.int8),
        lambda j: interop.ivf_flat_index_from_numpy(
            j.centers, j.center_norms, j.sorted_data, j.sorted_norms, *_lists(j), j.q_scale,
            j.metric, j.window, j.n_rows, device="cpu"),
        lambda t, q: ivf_flat.search(t, q, 5, n_probes=4, scan_algo="fused")),
    "ivf_pq": (
        lambda x: jax_pq.build(x, n_lists=8, pq_dim=8, pq_bits=5, seed=0),
        lambda j: interop.ivf_pq_index_from_numpy(
            j.centers, j.center_norms, j.centers_rot, j.rotation, j.pq_centers, j.sorted_codes,
            *_lists(j), j.metric, j.window, j.n_rows, j.pq_bits, j.sorted_codes_t,
            j.sorted_code_norms, device="cpu"),
        lambda t, q: ivf_pq.search(t, q, 5, n_probes=4, scan_algo="fused")),
    "ivf_pq_per_cluster": (
        lambda x: jax_pq.build(x, n_lists=8, pq_dim=6, pq_bits=5, seed=0,
                               codebook_gen="per_cluster"),
        lambda j: interop.ivf_pq_index_from_numpy(
            j.centers, j.center_norms, j.centers_rot, j.rotation, j.pq_centers, j.sorted_codes,
            *_lists(j), j.metric, j.window, j.n_rows, j.pq_bits, device="cpu",
            codebook_gen="per_cluster", pq_dim=j.pq_dim_static),
        lambda t, q: ivf_pq.search(t, q, 5, n_probes=4, scan_algo="query_major")),
    "ivf_sq": (
        lambda x: jax_sq.build(x, n_lists=8, seed=0),
        lambda j: interop.ivf_sq_index_from_numpy(
            j.centers, j.center_norms, j.sorted_codes, j.sorted_norms, j.q_min, j.q_max,
            *_lists(j), j.metric, j.window, j.n_rows, device="cpu"),
        lambda t, q: ivf_sq.search(t, q, 5, n_probes=4)),
    "ivf_rabitq": (
        lambda x: jax_rq.build(x, n_lists=8, bits_per_dim=3, seed=0),
        lambda j: interop.ivf_rabitq_index_from_numpy(
            j.centers, j.center_norms, j.rotation, j.centers_rot, j.sorted_codes, j.sorted_fadd,
            j.sorted_frescale, *_lists(j), j.metric, j.window, j.n_rows, j.bits_per_dim,
            j.sorted_codes_t, device="cpu"),
        lambda t, q: ivf_rabitq.search(t, q, 5, n_probes=4, scan_algo="fused")),
    "cagra": (
        lambda x: _jax_cagra(x),
        lambda j: interop.cagra_index_from_numpy(j.dataset, j.dataset_norms, j.graph, j.metric,
                                                 device="cpu"),
        lambda t, q: cagra.search(t, q, 5, seed=3)),
    "cagra_compressed": (
        lambda x: jax_cagra.compress(_jax_cagra(x), vq_n_centers=16, pq_dim=8),
        lambda j: interop.cagra_compressed_index_from_numpy(
            j.vq_centers, j.vq_codes, j.pq_codes, j.pq_codebooks, j.dataset_norms, j.graph,
            j.metric, device="cpu"),
        lambda t, q: cagra.search(t, q, 5, seed=3)),
    "cagra_packed": (  # three pieces of the neighbour axis, keyed .child_vecs[i]
        lambda x: jax_cagra.pack(_jax_cagra(x), _piece_bytes=1500 * 24 * 6),
        lambda j: interop.cagra_packed_index_from_numpy(
            j.graph, j.child_vecs, j.child_norms, j.dataset_int8, j.dataset_norms, j.scale,
            j.metric, device="cpu"),
        lambda t, q: cagra.search(t, q, 5, seed=3)),
}


def _jax_cagra(x):
    return jax_cagra.build(x, intermediate_graph_degree=32, graph_degree=16, seed=0)


def _own_cagra(xt):
    return cagra.build(xt, intermediate_graph_degree=32, graph_degree=16, seed=0)


def _same_index(a, b):
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype and torch.equal(v, w), k
        elif isinstance(v, tuple):  # SortedLists
            assert all(torch.equal(p, r) for p, r in zip(v, w)), k
        else:
            assert v == w, k


@pytest.mark.parametrize("kind", list(_KINDS))
def test_reference_files_load_and_search_identically(tmp_path, data, kind):
    x, q = data
    build, carry, search = _KINDS[kind]
    j = build(x)
    path = str(tmp_path / "ref.npz")
    jax_serialize.save(path, j)
    loaded = serialize.load(path, device="cpu")
    _same_index(loaded, carry(j))
    qt = torch.from_numpy(q)
    a, b = search(loaded, qt), search(carry(j), qt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # and the port writes it back as it read it
    path2 = str(tmp_path / "port.npz")
    serialize.save(path2, loaded)
    _same_index(serialize.load(path2, expected_kind=serialize.kind_of(loaded), device="cpu"),
                loaded)


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat_bf16", "ivf_pq", "ivf_pq_per_cluster",
                                  "ivf_sq", "ivf_rabitq", "cagra", "cagra_compressed",
                                  "cagra_packed"])
def test_own_index_round_trip(tmp_path, data, kind):
    x, q = data
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    own = {"brute_force": lambda: brute_force.build(xt, metric="euclidean"),
           "ivf_flat_bf16": lambda: ivf_flat.build(xt, n_lists=8, seed=0,
                                                   storage_dtype=torch.bfloat16),
           "ivf_pq": lambda: ivf_pq.build(xt, n_lists=8, pq_dim=8, pq_bits=5, seed=0),
           "ivf_pq_per_cluster": lambda: ivf_pq.build(xt, n_lists=8, pq_dim=6, pq_bits=5, seed=0,
                                                      codebook_gen="per_cluster"),
           "ivf_sq": lambda: ivf_sq.build(xt, n_lists=8, seed=0),
           "ivf_rabitq": lambda: ivf_rabitq.build(xt, n_lists=8, bits_per_dim=3, seed=0),
           # tests/test_serialize.py's test_cagra_compressed_roundtrip and the
           # packed part of test_int8_and_packed_roundtrip
           "cagra": lambda: _own_cagra(xt),
           "cagra_compressed": lambda: cagra.compress(_own_cagra(xt), vq_n_centers=16, pq_dim=8),
           "cagra_packed": lambda: cagra.pack(_own_cagra(xt), _piece_bytes=1500 * 24 * 6),
           }[kind]()
    path = str(tmp_path / "own.npz")
    serialize.save(path, own)
    loaded = serialize.load(path, device="cpu")
    assert type(loaded) is type(own)
    _same_index(loaded, own)
    a, b = _KINDS[kind][2](loaded, qt), _KINDS[kind][2](own, qt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_flat_int8", "ivf_sq"])
def test_reference_loads_port_files(tmp_path, data, kind):
    x, q = data
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    if kind == "brute_force":
        own = brute_force.build(xt, metric="euclidean")
        jmod, tmod, kw = jax_bf, brute_force, {}
    elif kind == "ivf_sq":
        own = ivf_sq.build(xt, n_lists=8, seed=0)
        jmod, tmod, kw = jax_sq, ivf_sq, dict(n_probes=4)
    else:
        own = ivf_flat.build(xt, n_lists=8, seed=0,
                             storage_dtype=torch.int8 if kind == "ivf_flat_int8" else None)
        jmod, tmod, kw = jax_flat, ivf_flat, dict(n_probes=4, scan_algo="query_major")
    path = str(tmp_path / "own.npz")
    serialize.save(path, own)
    jd, ji = jmod.search(jax_serialize.load(path), q, 5, **kw)
    td, ti = tmod.search(own, qt, 5, **kw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5, 1e-4)


@pytest.mark.parametrize("kind", ["cagra", "cagra_compressed", "cagra_packed"])
def test_reference_loads_port_cagra_files(tmp_path, data, kind):
    """Each CAGRA kind the port writes loads in the JAX package with the same
    arrays (the two packages draw other search seeds, so the searches are
    compared in test_torch_cagra*.py, not here)."""
    x, _ = data
    j = _KINDS[kind][0](x)
    own = _KINDS[kind][1](j)
    path = str(tmp_path / "own.npz")
    serialize.save(path, own)
    back = jax_serialize.load(path)
    assert type(back) is type(j) and back.metric == j.metric
    ref = jax_serialize._arrays_of(j)
    got = jax_serialize._arrays_of(back)
    assert sorted(ref) == sorted(got)
    for key, arr in ref.items():
        assert got[key].dtype == arr.dtype and np.array_equal(got[key], arr), key


def test_packed_file_with_one_child_vecs_key_loads(tmp_path, data):
    """The reference's older packed files hold the child array under one
    ``.child_vecs`` key (cuvs_tpu/utils/serialize.py:126-129)."""
    x, q = data
    pk = cagra.pack(_own_cagra(torch.from_numpy(x)))
    arrays = serialize._arrays_of(pk, "cagra.PackedIndex")
    arrays[".child_vecs"] = arrays.pop(".child_vecs[0]")
    header = {"magic": serialize.MAGIC, "version": serialize.VERSION, "kind": "cagra.PackedIndex",
              "statics": {"metric": int(pk.metric)}, "arrays": sorted(arrays)}
    path = tmp_path / "old.npz"
    np.savez(path, __header__=np.frombuffer(json.dumps(header).encode(), np.uint8),
             **{f"a{i}": arr for i, (_, arr) in enumerate(sorted(arrays.items()))})
    back = serialize.load(str(path), device="cpu")
    _same_index(back, pk)
    qt = torch.from_numpy(q)
    assert torch.equal(cagra.search(back, qt, 5)[1], cagra.search(pk, qt, 5)[1])


def test_bad_headers_rejected(tmp_path, data):
    """tests/test_serialize.py:113-135."""
    p = tmp_path / "bad.npz"
    np.savez(p, __header__=np.frombuffer(b'{"magic": "evil"}', np.uint8))
    with pytest.raises(ValueError, match="magic"):
        serialize.load(str(p), device="cpu")
    x, _ = data
    path = str(tmp_path / "i.npz")
    serialize.save(path, brute_force.build(torch.from_numpy(x[:100])))
    with pytest.raises(ValueError, match="expected"):
        serialize.load(path, expected_kind="cagra", device="cpu")
    for kind, version, err, match in (("brute_force", 999, ValueError, "version"),
                                      ("spam", 1, ValueError, "unknown")):
        hdr = {"magic": serialize.MAGIC, "version": version, "kind": kind, "statics": {},
               "arrays": []}
        p = tmp_path / f"{kind}.npz"
        np.savez(p, __header__=np.frombuffer(json.dumps(hdr).encode(), np.uint8))
        with pytest.raises(err, match=match):
            serialize.load(str(p), device="cpu")
