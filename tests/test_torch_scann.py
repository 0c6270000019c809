"""ScaNN: the port against the JAX package on the CPU, and the port's own
builds (tests/test_scann.py's six tests).

Given the reference's centres and labels, ``_avq_refine`` returns its
centres to rtol 1e-4 (whole and in row chunks; an empty cluster keeps its
centre) and ``_soar_assign`` its labels. For the same index the asset
directory is file for file byte-identical to the reference's, and each
package reads the other's.
"""

import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.cluster import kmeans_balanced as jax_kmeans
from cuvs_tpu.neighbors import scann as jax_scann
from cuvs_tpu_torch import interop
from cuvs_tpu_torch.neighbors import scann
from tests.utils import make_blobs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def partitioned():
    """Rows, the reference's balanced k-means centres and labels; cluster 5
    is emptied (its rows relabelled to 6)."""
    x = make_blobs(np.random.default_rng(91), 3000, 16)
    centers = np.asarray(jax_kmeans.fit(x, 16, seed=0))
    labels = np.asarray(jax_kmeans.predict(x, centers)).astype(np.int32)
    labels[labels == 5] = 6
    return x, centers, labels


@pytest.mark.parametrize("chunk", [0, 700])
def test_avq_refine_matches_reference(partitioned, chunk):
    x, centers, labels = partitioned
    ref = np.asarray(jax_scann._avq_refine(jnp.asarray(x), jnp.asarray(centers),
                                           jnp.asarray(labels), 2.0))
    got = scann._avq_refine(torch.from_numpy(x), torch.from_numpy(centers),
                            torch.from_numpy(labels), 2.0, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert np.array_equal(got.numpy()[5], centers[5])  # no rows: the centre stays


@pytest.mark.parametrize("chunk", [0, 700])
def test_soar_assign_matches_reference(partitioned, chunk):
    x, centers, labels = partitioned
    ref = np.asarray(jax_scann._soar_assign(jnp.asarray(x), jnp.asarray(centers),
                                            jnp.asarray(labels), 1.5))
    got = scann._soar_assign(torch.from_numpy(x), torch.from_numpy(centers),
                             torch.from_numpy(labels), 1.5, chunk=chunk)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert (ref != labels).all()


def _carried(j):
    return interop.scann_index_from_numpy(
        j.centers, j.labels, j.soar_labels, j.codes, j.pq_codebooks, j.residuals_bf16,
        j.codes_soar, j.bf16_dataset, j.params, device="cpu")


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


@pytest.mark.parametrize("case", ["pq_soar_bf16_dataset", "bf16_residuals"])
def test_assets_match_reference_bytes(tmp_path, case):
    x = make_blobs(np.random.default_rng(92), 1200, 16)
    if case == "pq_soar_bf16_dataset":
        kw = dict(n_lists=8, pq_dim=8, partitioning_eta=2.0, reordering_bf16=True)
    else:
        kw = dict(n_lists=8, bf16_residuals=True, spilling=False)
    j = jax_scann.build(x, seed=0, **kw)
    ref, own = str(tmp_path / "ref"), str(tmp_path / "own")
    jax_scann.serialize(j, ref)
    t = _carried(j)
    scann.serialize(t, own)
    _same_dirs(ref, own)
    back = scann.deserialize(ref, device="cpu")
    jback = jax_scann.deserialize(own)
    for name in ("centers", "labels", "soar_labels", "codes", "pq_codebooks", "codes_soar"):
        a, b = getattr(back, name), getattr(jback, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), name
    for name in ("residuals_bf16", "bf16_dataset"):
        a, b = getattr(back, name), getattr(jback, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == torch.bfloat16
            assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32)), name
    # the manifest keeps no pq_dim or spilling of its own: both read the same params back
    jref = jax_scann.deserialize(ref).params
    assert back.params == scann.IndexParams(**{f: getattr(jref, f)
                                               for f in scann.IndexParams.__dataclass_fields__})


# --- the port's own builds, held to tests/test_scann.py's checks ---

RNG = np.random.default_rng(91)


def test_build_and_assets(tmp_path):
    x = make_blobs(RNG, 5000, 32)
    idx = scann.build(x, n_lists=32, partitioning_eta=2.0, soar_lambda=1.5, pq_dim=16, seed=0,
                      device="cpu")
    assert idx.centers.shape == (32, 32) and idx.labels.shape == (5000,)
    assert idx.soar_labels is not None and bool((idx.soar_labels != idx.labels).all())
    assert idx.codes.shape == (5000, 16) and idx.codes.dtype == torch.uint8
    d = str(tmp_path / "scann_assets")
    scann.serialize(idx, d)
    for f in ("cuvs_metadata.bin", "centers.npy", "datapoint_to_token.npy", "hashed_dataset.npy",
              "hashed_dataset_soar.npy", "pq_codebook.npy", "scann_config.json"):
        assert os.path.exists(os.path.join(d, f)), f
    with open(os.path.join(d, "scann_config.json")) as f:
        cfg = json.load(f)
    assert cfg["n_lists"] == 32 and cfg["n_rows"] == 5000


def test_partition_quality():
    x = make_blobs(RNG, 4000, 16, n_centers=16)
    idx = scann.build(x, n_lists=16, partitioning_eta=1.0, spilling=False, seed=0, device="cpu")
    res = x - idx.centers.numpy()[idx.labels.numpy()]
    assert np.linalg.norm(res) < 0.5 * np.linalg.norm(x)


def test_avq_eta_changes_centroids():
    x = make_blobs(RNG, 2000, 8)
    a = scann.build(x, n_lists=8, partitioning_eta=1.0, spilling=False, seed=0, device="cpu")
    b = scann.build(x, n_lists=8, partitioning_eta=3.0, spilling=False, seed=0, device="cpu")
    assert not torch.allclose(a.centers, b.centers)


def test_bf16_storage():
    x = make_blobs(RNG, 1000, 8)
    idx = scann.build(x, n_lists=8, bf16_residuals=True, spilling=False, seed=0, device="cpu")
    assert idx.codes is None and idx.residuals_bf16.dtype == torch.bfloat16


def test_asset_bytes_golden(tmp_path):
    import struct

    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    idx = scann.Index(
        centers=t(np.arange(12, dtype=np.float32).reshape(3, 4)),
        labels=t(np.array([0, 1, 2, 1], np.int32)),
        soar_labels=t(np.array([1, 1, 0, 2], np.int32)),  # row 1: equal -> -1 on disk
        codes=t(np.array([[1, 2], [3, 4], [5, 6], [7, 8]], np.uint8)),
        pq_codebooks=t(np.zeros((2, 4, 2), np.float32)), residuals_bf16=None,
        codes_soar=t(np.array([[1, 2], [3, 4], [5, 6], [7, 8]], np.uint8)),
        params=scann.IndexParams(n_lists=3, pq_dim=2))
    d = str(tmp_path / "assets")
    scann.serialize(idx, d)
    with open(os.path.join(d, "cuvs_metadata.bin"), "rb") as f:
        assert f.read() == struct.pack("<iII", 1, 4, 2)
    tok = np.load(os.path.join(d, "datapoint_to_token.npy"))
    assert tok.dtype == np.int32
    np.testing.assert_array_equal(tok, [0, 1, 1, -1, 2, 0, 1, 2])
    hashed = np.load(os.path.join(d, "hashed_dataset.npy"))
    assert hashed.dtype == np.uint8 and np.array_equal(hashed, idx.codes.numpy())
    idx2 = scann.deserialize(d, device="cpu")
    assert torch.equal(idx2.labels, idx.labels) and torch.equal(idx2.soar_labels, idx.soar_labels)


def test_soar_codes_and_bf16_dataset(tmp_path):
    x = make_blobs(RNG, 1200, 16)
    idx = scann.build(x, n_lists=8, pq_dim=8, reordering_bf16=True, seed=0, device="cpu")
    assert idx.codes_soar is not None and idx.codes_soar.shape == idx.codes.shape
    assert bool((idx.codes_soar != idx.codes).any())
    assert idx.bf16_dataset is not None
    d = str(tmp_path / "assets")
    scann.serialize(idx, d)
    assert np.load(os.path.join(d, "bf16_dataset.npy")).dtype == np.int16
    idx2 = scann.deserialize(d, device="cpu")
    assert torch.equal(idx2.bf16_dataset.view(torch.int16), idx.bf16_dataset.view(torch.int16))
