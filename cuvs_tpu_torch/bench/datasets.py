"""Benchmark datasets: registry, loading, ground truth — port of ``cuvs_tpu.bench.datasets``.

The registry entries, the big-ann ``.fbin/.u8bin/.i8bin`` reader and the
seeded synthetic stand-in are the reference's, so both packages load
byte-identical arrays (the reference's module cannot be imported without JAX).
Real datasets load from ``$CUVS_TPU_DATASET_DIR/<base_file>``; when the files
are absent, a seeded synthetic dataset of the standard shape stands in.
``groundtruth`` caches in the reference's ``.npz`` file, so each package reads
the other's cache.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.utils.device import as_tensor

# base files above this many bytes are read by the host library's threaded reader
_NATIVE_READ_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class Spec:
    """One datasets.yaml entry (name, shape, files, metric)."""

    n_base: int
    dims: int
    n_query: int
    metric: str
    base_file: str = ""
    query_file: str = ""
    gt_file: str = ""
    dtype: str = "float32"  # stored element type of base/query files
    subset_size: int = 0  # read only the first N rows of base_file


def _std(name, n, d, nq, metric, dtype="float32", subset=0,
         base=None, query=None, gt=None):
    return Spec(
        n_base=n, dims=d, n_query=nq, metric=metric, dtype=dtype,
        subset_size=subset,
        base_file=base or f"{name}/base.fbin",
        query_file=query or f"{name}/query.fbin",
        gt_file=gt or f"{name}/groundtruth.neighbors.ibin",
    )


# mirrors cuvs_bench datasets.yaml (all entries) plus synthetic stand-ins
REGISTRY = {
    "bigann-1B": _std("bigann-1B", 1_000_000_000, 128, 10_000, "sqeuclidean",
                      dtype="uint8", base="bigann-1B/base.1B.u8bin",
                      query="bigann-1B/query.public.10K.u8bin"),
    "deep-1B": _std("deep-1B", 1_000_000_000, 96, 10_000, "inner_product",
                    base="deep-1B/base.1B.fbin",
                    query="deep-1B/query.public.10K.fbin"),
    "bigann-100M": _std("bigann-100M", 100_000_000, 128, 10_000, "sqeuclidean",
                        dtype="uint8", subset=100_000_000,
                        base="bigann-100M/base.1B.u8bin",
                        query="bigann-100M/query.public.10K.u8bin"),
    "deep-100M": _std("deep-100M", 100_000_000, 96, 10_000, "sqeuclidean",
                      subset=100_000_000, base="deep-100M/base.1B.fbin",
                      query="deep-100M/query.public.10K.fbin",
                      gt="deep-100M/groundtruth.public.10K.ibin"),
    "deep-image-96-inner": _std("deep-image-96-inner", 9_990_000, 96, 10_000,
                                "inner_product"),
    "fashion-mnist-784-euclidean": _std("fashion-mnist-784-euclidean", 60_000,
                                        784, 10_000, "sqeuclidean"),
    "gist-960-euclidean": _std("gist-960-euclidean", 1_000_000, 960, 1_000,
                               "sqeuclidean"),
    "glove-50-angular": _std("glove-50-angular", 1_183_514, 50, 10_000, "cosine"),
    "glove-50-inner": _std("glove-50-inner", 1_183_514, 50, 10_000, "inner_product"),
    "glove-100-angular": _std("glove-100-angular", 1_183_514, 100, 10_000, "cosine"),
    "glove-100-inner": _std("glove-100-inner", 1_183_514, 100, 10_000, "inner_product"),
    "lastfm-65-angular": _std("lastfm-65-angular", 292_385, 65, 50_000, "cosine"),
    "mnist-784-euclidean": _std("mnist-784-euclidean", 60_000, 784, 10_000,
                                "sqeuclidean"),
    "nytimes-256-angular": _std("nytimes-256-angular", 290_000, 256, 10_000, "cosine"),
    "nytimes-256-inner": _std("nytimes-256-inner", 290_000, 256, 10_000,
                              "inner_product"),
    "sift-128-euclidean": _std("sift-128-euclidean", 1_000_000, 128, 10_000,
                               "sqeuclidean"),
    "test-data": _std("test-data", 10_000, 32, 100, "sqeuclidean",
                      base="test-data/ann_benchmarks_like.base.fbin",
                      query="test-data/ann_benchmarks_like.query.fbin",
                      gt="test-data/ann_benchmarks_like.groundtruth.neighbors.ibin"),
    "wiki_all_1M": _std("wiki_all_1M", 1_000_000, 768, 10_000, "sqeuclidean",
                        base="wiki_all_1M/base.1M.fbin",
                        query="wiki_all_1M/queries.fbin",
                        gt="wiki_all_1M/groundtruth.1M.neighbors.ibin"),
    "wiki_all_10M": _std("wiki_all_10M", 10_000_000, 768, 10_000, "sqeuclidean",
                         base="wiki_all_10M/base.10M.fbin",
                         query="wiki_all_10M/queries.fbin",
                         gt="wiki_all_10M/groundtruth.10M.neighbors.ibin"),
    "wiki_all_88M": _std("wiki_all_88M", 88_000_000, 768, 10_000, "sqeuclidean",
                         base="wiki_all_88M/base.88M.fbin",
                         query="wiki_all_88M/queries.fbin",
                         gt="wiki_all_88M/groundtruth.88M.neighbors.ibin"),
    # synthetic stand-ins with standard shapes (not in the reference)
    "synthetic-100k-96": _std("synthetic-100k-96", 100_000, 96, 10_000, "sqeuclidean"),
    "synthetic-1m-96": _std("synthetic-1m-96", 1_000_000, 96, 10_000, "sqeuclidean"),
    "synthetic-1m-128": _std("synthetic-1m-128", 1_000_000, 128, 10_000, "sqeuclidean"),
    "synthetic-10m-96": _std("synthetic-10m-96", 10_000_000, 96, 10_000, "sqeuclidean"),
}


@dataclasses.dataclass
class Dataset:
    name: str
    base: np.ndarray
    queries: np.ndarray
    metric: str
    synthetic: bool
    gt_ids: Optional[np.ndarray] = None  # provided groundtruth, if any


def dataset_dir() -> Optional[str]:
    return os.environ.get("CUVS_TPU_DATASET_DIR")


def _read_bin(path: str, dtype: str, max_rows: Optional[int] = None) -> np.ndarray:
    """big-ann .fbin/.u8bin/.i8bin reader (uint32 n, uint32 dim header)."""
    if path.endswith((".u8bin",)) or dtype == "uint8":
        elem = np.uint8
    elif path.endswith((".i8bin",)) or dtype == "int8":
        elem = np.int8
    elif path.endswith((".ibin",)):
        elem = np.int32
    else:
        elem = np.float32
    with open(path, "rb") as f:
        n, dim = np.fromfile(f, np.uint32, 2)
        n = int(n) if max_rows is None else min(int(n), max_rows)
        return np.fromfile(f, elem, n * int(dim)).reshape(n, int(dim))


def load(name: str, max_rows: Optional[int] = None, seed: int = 0) -> Dataset:
    if name not in REGISTRY:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(REGISTRY)}")
    spec = REGISTRY[name]
    n = spec.n_base
    if spec.subset_size:
        n = min(n, spec.subset_size)
    if max_rows:
        n = min(n, max_rows)
    root = dataset_dir()
    if root:
        base_path = os.path.join(root, spec.base_file)
        query_path = os.path.join(root, spec.query_file)
        gt_path = os.path.join(root, spec.gt_file)
        if os.path.exists(base_path):
            if base_path.endswith(".fbin") and os.path.getsize(base_path) > _NATIVE_READ_BYTES:
                from cuvs_tpu_torch import io as cio  # the host library's threaded reader

                with cio.BinDataset(base_path) as d:
                    base = d.read(0, min(n, d.n_rows))
            else:
                base = _read_bin(base_path, spec.dtype, n)
            queries = (
                _read_bin(query_path, spec.dtype)
                if os.path.exists(query_path)
                else base[: spec.n_query].copy()
            )
            # the .ibin ground truth refers to the FULL base (or the
            # spec's subset cut): attaching it to a max_rows-truncated
            # base would score recall against ids that don't exist in the
            # index, silently deflating every contender
            gt_ref_rows = spec.subset_size or spec.n_base
            gt = (
                _read_bin(gt_path, "int32")
                if os.path.exists(gt_path) and base.shape[0] >= gt_ref_rows
                else None
            )
            return Dataset(name, base, queries[: spec.n_query], spec.metric,
                           synthetic=False, gt_ids=gt)
    # synthetic stand-in with realistic structure: embedding-like data has
    # low intrinsic dimension (~dim/4), which is what makes ANN work; pure
    # iid gaussians are the degenerate worst case and would make recall
    # numbers meaningless
    dim, nq = spec.dims, spec.n_query
    rng = np.random.default_rng(seed)
    r = max(8, dim // 4)
    proj = rng.standard_normal((r, dim)).astype(np.float32) / np.sqrt(r)
    base = rng.standard_normal((n, r), dtype=np.float32) @ proj
    base += 0.05 * rng.standard_normal((n, dim), dtype=np.float32)
    queries = rng.standard_normal((nq, r), dtype=np.float32) @ proj
    queries += 0.05 * rng.standard_normal((nq, dim), dtype=np.float32)
    return Dataset(name, base, queries, spec.metric, synthetic=True)


def download(name: str, dest: Optional[str] = None) -> str:
    """Placeholder for cuvs_bench.get_dataset: there is no network egress, so
    datasets must be staged into CUVS_TPU_DATASET_DIR out of band (the same
    .fbin layout as the reference's download tooling)."""
    raise RuntimeError(
        f"no network egress: place {REGISTRY[name].base_file} under "
        f"$CUVS_TPU_DATASET_DIR ({dest or dataset_dir() or 'unset'})"
    )


def on_device(a, device=None) -> torch.Tensor:
    """Rows as a tensor on ``device`` (None: the CUDA card; a tensor keeps its
    device unless ``device`` is given). float64 becomes float32, as the
    reference's ``jnp.asarray`` makes it with x64 off; other dtypes are kept."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        a = a.astype(np.float32) if a.dtype == np.float64 else a
    t = as_tensor(a, device)
    return t.float() if t.dtype == torch.float64 else t


def groundtruth(ds: Dataset, k: int = 100, gt_queries: int = 1024,
                cache_dir: Optional[str] = None, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN ground truth (generate_groundtruth analog): (dists, ids) as
    numpy [gt_queries, k] float32 / int32, from an unfused exact brute-force
    search on ``device`` (None: the card, or the device of ``ds.base`` when it
    is a tensor). Uses the dataset's provided .ibin ground truth when
    available, with zeros for the distances, as the reference does."""
    if ds.gt_ids is not None and ds.gt_ids.shape[0] >= gt_queries:
        return np.zeros((gt_queries, min(k, ds.gt_ids.shape[1])), np.float32), (
            ds.gt_ids[:gt_queries, :k]
        )
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir, f"{ds.name}-n{ds.base.shape[0]}-q{gt_queries}-k{k}.npz"
        )
        if os.path.exists(cache):
            z = np.load(cache)
            return z["dists"], z["ids"]
    from cuvs_tpu_torch.neighbors import brute_force

    base = on_device(ds.base, device)
    index = brute_force.build(base, metric=ds.metric)
    d, i = brute_force.search(index, on_device(ds.queries[:gt_queries], base.device), k)
    d, i = d.cpu().numpy(), i.cpu().numpy()
    if cache:
        np.savez(cache, dists=d, ids=i)
    return d, i
