"""ScaNN-style build-only index: AVQ partitioning, SOAR spilling and PQ —
port of ``cuvs_tpu.neighbors.scann``.

``cuvs::neighbors::scann`` (scann.hpp: build :295-300, serialize :320,
partitioning_eta :51-76, soar_lambda and soar_labels :200; detail
scann_{avq,soar,quantize,build,serialize}.cuh). As in the reference this is
build and serialize only: serving happens in CPU ScaNN.

  * AVQ centres ("Accelerating Large-Scale Inference with Anisotropic Vector
    Quantization", ICML 2020) minimise the eta-weighted parallel loss plus
    the orthogonal loss: per cluster, solve
    (sum_x [(eta - 1) / |x|^2 x x^T + I]) c = sum_x eta x.
  * SOAR gives each row a second partition, argmin over c2 != c1 of
    |x - c2|^2 + lambda ((x - c2) . r1^)^2 with r1^ the primary residual's
    direction, so the two quantization errors de-correlate.

At 1M rows the reference's [n, d, d] outer products (65 GB at d = 128) and
its three [n, n_lists] score blocks (12 GB at 1024 lists) do not fit a card's
working budget: the port accumulates the AVQ systems over label-sorted row
chunks and scores SOAR in row chunks, each within ``_CHUNK_BYTES``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.preprocessing import quantize
from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.device import resolve_device

_CHUNK_BYTES = 1 << 30  # f32 transient of one AVQ or SOAR chunk


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Mirrors scann::index_params (scann.hpp:51-200)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.InnerProduct
    partitioning_eta: float = 1.0  # anisotropic weight (1.0 = isotropic)
    soar_lambda: float = 1.5
    spilling: bool = True
    pq_dim: int = 0  # 0 = dim / 2
    pq_bits: int = 8
    kmeans_n_iters: int = 20
    bf16_residuals: bool = False  # store bf16 residuals instead of PQ codes
    reordering_bf16: bool = False  # also keep a bf16 copy of the dataset
    # (scann.hpp:70-71) for ScaNN's exact re-rank stage
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "metric", normalize_metric(self.metric))


@dataclasses.dataclass
class Index:
    centers: torch.Tensor  # [n_lists, d] AVQ partition centres
    labels: torch.Tensor  # [n] int32 primary assignment
    soar_labels: Optional[torch.Tensor]  # [n] int32 secondary (spilled) assignment
    codes: Optional[torch.Tensor]  # [n, pq_dim] uint8 PQ codes of the residuals
    pq_codebooks: Optional[torch.Tensor]  # [pq_dim, book, pq_len]
    residuals_bf16: Optional[torch.Tensor]  # [n, d] bf16, the alternative storage
    codes_soar: Optional[torch.Tensor] = None  # [n, pq_dim] codes of the residuals
    # against the SOAR centre (scann_build.cuh:214-223)
    bf16_dataset: Optional[torch.Tensor] = None  # [n, d] bf16 copy of the dataset
    params: IndexParams = None

    @property
    def size(self) -> int:
        return self.labels.shape[0]


def _rows_per_chunk(row_bytes: int) -> int:
    return max(1, _CHUNK_BYTES // max(row_bytes, 1))


def _avq_refine(x, centers, labels, eta: float, chunk: int = 0) -> torch.Tensor:
    """One anisotropic centroid update (scann_avq.cuh). Per cluster
    A = sum w x x^T + count I with w = (eta - 1) / |x|^2, b = sum eta x,
    then c = solve(A + 1e-6 I, b); a cluster with no rows keeps its centre.

    A is summed over rows sorted by label, ``chunk`` rows at a time (0:
    [chunk, d, d] within _CHUNK_BYTES): each chunk's outer products are
    reduced per label segment and added to their clusters, so the sums are
    the same on every run."""
    n, d = x.shape
    k = centers.shape[0]
    dev = x.device
    labels = labels.long()
    w = (eta - 1.0) / torch.clamp_min((x * x).sum(1), 1e-30)
    counts = torch.bincount(labels, minlength=k)
    order = torch.argsort(labels, stable=True)
    A = torch.zeros((k, d, d), dtype=torch.float32, device=dev)
    b = torch.zeros((k, d), dtype=torch.float32, device=dev)
    chunk = chunk or _rows_per_chunk(4 * d * d)
    for s in range(0, n, chunk):
        rows = order[s:s + chunk]
        xc, lc = x[rows], labels[rows]
        segs, lengths = torch.unique_consecutive(lc, return_counts=True)
        outer = (xc[:, :, None] * xc[:, None, :]) * w[rows][:, None, None]
        A.index_add_(0, segs, torch.segment_reduce(outer.reshape(len(rows), d * d), "sum",
                                                   lengths=lengths).reshape(-1, d, d))
        b.index_add_(0, segs, torch.segment_reduce(xc * eta, "sum", lengths=lengths))
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    A = A + counts.float()[:, None, None] * eye[None]
    sol = torch.linalg.solve(A + 1e-6 * eye[None], b[:, :, None])[:, :, 0]
    return torch.where(counts[:, None] > 0, sol, centers)


def _soar_assign(x, centers, labels, lam: float, chunk: int = 0) -> torch.Tensor:
    """Secondary assignments (scann_soar.cuh): argmin over c2 != c1 of
    |x - c2|^2 + lambda ((x - c2) . r1^)^2, in row chunks of ``chunk`` (0:
    three [chunk, n_lists] f32 blocks within _CHUNK_BYTES). Returns [n]
    int32."""
    n = x.shape[0]
    chunk = chunk or _rows_per_chunk(3 * 4 * centers.shape[0])
    cn = (centers * centers).sum(1)[None, :]
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    for s in range(0, n, chunk):
        xc, lc = x[s:s + chunk], labels[s:s + chunk].long()
        r1 = xc - centers[lc]
        r1_hat = r1 / torch.clamp_min(torch.linalg.norm(r1, dim=1, keepdim=True), 1e-30)
        d2 = (xc * xc).sum(1)[:, None] + cn - 2.0 * pairwise._gemm(xc, centers)
        proj = (xc * r1_hat).sum(1)[:, None] - pairwise._gemm(r1_hat, centers)
        score = d2 + lam * proj * proj
        score[torch.arange(xc.shape[0], device=x.device), lc] = float("inf")
        out[s:s + chunk] = torch.argmin(score, dim=1).to(torch.int32)
    return out


def build(dataset, params: Optional[IndexParams] = None, device=None, **kw) -> Index:
    """Balanced k-means partitions (refined by AVQ when eta != 1), SOAR
    labels, and PQ codes of the residuals against both centres with one
    codebook (or bf16 residuals). Host data goes to ``device`` (None: the
    CUDA card)."""
    if params is None:
        params = IndexParams(**kw)
    x = _on_device(dataset, device).float()
    n, d = x.shape
    n_lists = min(params.n_lists, n)
    centers = kmeans_balanced.fit(x, n_lists, kmeans_balanced.BalancedParams(
        n_clusters=n_lists, n_iters=params.kmeans_n_iters, seed=params.seed))
    labels = kmeans_balanced.predict(x, centers)
    if params.partitioning_eta != 1.0:
        centers = _avq_refine(x, centers, labels, params.partitioning_eta)
        labels = kmeans_balanced.predict(x, centers)

    soar = None
    if params.spilling and n_lists > 1:
        soar = _soar_assign(x, centers, labels, params.soar_lambda)

    residuals = x - centers[labels.long()]
    codes = books = res_bf16 = codes_soar = None
    if params.bf16_residuals:
        res_bf16 = residuals.to(torch.bfloat16)
    else:
        pqq = quantize.pq_train(residuals, params.pq_dim or max(1, d // 2), params.pq_bits,
                                seed=params.seed)
        codes = quantize.pq_transform(pqq, residuals)
        books = pqq.codebooks
        if soar is not None:  # the same codebooks (scann_build.cuh:214-223)
            codes_soar = quantize.pq_transform(pqq, x - centers[soar.long()])
    return Index(centers=centers, labels=labels, soar_labels=soar, codes=codes,
                 pq_codebooks=books, residuals_bf16=res_bf16, codes_soar=codes_soar,
                 bf16_dataset=x.to(torch.bfloat16) if params.reordering_bf16 else None,
                 params=params)


def _np(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def serialize(index: Index, directory: str) -> None:
    """Write a ScaNN asset directory, file for file the reference's
    (scann_serialize.cuh:106-142):

    * ``cuvs_metadata.bin``: raw little-endian i32 version = 1, u32 dim,
      u32 pq_dim;
    * ``centers.npy`` [n_lists, d] f32;
    * ``datapoint_to_token.npy`` i32 [2n], (primary, soar) interleaved, soar
      -1 where it equals the primary (save_labels, :56-89);
    * ``pq_codebook.npy`` f32, ``hashed_dataset.npy`` and
      ``hashed_dataset_soar.npy`` u8 [n, pq_dim];
    * ``bf16_dataset.npy`` i16 [n, d] bf16 bit patterns (reordering_bf16);
    * ``bf16_residuals.npy`` f32, and ``scann_config.json``, the manifest
      this library reads back (ScaNN's tooling ignores both)."""
    os.makedirs(directory, exist_ok=True)
    n = index.size
    d = index.centers.shape[1]
    pq_dim = 0 if index.pq_codebooks is None else index.pq_codebooks.shape[0]
    with open(os.path.join(directory, "cuvs_metadata.bin"), "wb") as f:
        f.write(struct.pack("<iII", 1, d, pq_dim))
    np.save(os.path.join(directory, "centers.npy"), _np(index.centers).astype(np.float32))

    prim = _np(index.labels).astype(np.int32)
    soar = _np(index.soar_labels).astype(np.int32) if index.soar_labels is not None \
        else prim.copy()
    combined = np.empty((2 * n,), np.int32)
    combined[0::2] = prim
    combined[1::2] = np.where(soar == prim, np.int32(-1), soar)
    np.save(os.path.join(directory, "datapoint_to_token.npy"), combined)

    if index.codes is not None:
        np.save(os.path.join(directory, "pq_codebook.npy"),
                _np(index.pq_codebooks).astype(np.float32))
        np.save(os.path.join(directory, "hashed_dataset.npy"), _np(index.codes).astype(np.uint8))
        cs = index.codes_soar if index.codes_soar is not None else index.codes
        np.save(os.path.join(directory, "hashed_dataset_soar.npy"), _np(cs).astype(np.uint8))
    if index.bf16_dataset is not None:
        np.save(os.path.join(directory, "bf16_dataset.npy"),
                _np(index.bf16_dataset.view(torch.int16)))
    if index.residuals_bf16 is not None:
        np.save(os.path.join(directory, "bf16_residuals.npy"), _np(index.residuals_bf16.float()))
    p = index.params
    manifest = {
        "format": "cuvs_tpu.scann.v2",
        "n_lists": int(index.centers.shape[0]),
        "dim": int(d),
        "n_rows": int(n),
        "metric": int(p.metric),
        "soar_lambda": p.soar_lambda,
        "partitioning_eta": p.partitioning_eta,
        "pq_bits": p.pq_bits,
        "seed": p.seed,
        "has_soar": index.soar_labels is not None,
        "reordering_bf16": index.bf16_dataset is not None,
    }
    with open(os.path.join(directory, "scann_config.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def deserialize(directory: str, device=None) -> Index:
    """Read an asset directory written by ``serialize`` (or the reference's)
    into an Index on ``device`` (None: the CUDA card)."""
    with open(os.path.join(directory, "scann_config.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") not in ("cuvs_tpu.scann.v1", "cuvs_tpu.scann.v2"):
        raise ValueError("not a cuvs_tpu scann asset directory")

    def opt(name):
        p = os.path.join(directory, name)
        return np.load(p) if os.path.exists(p) else None

    dev = resolve_device(device)

    def tensor(a, dtype=None):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    combined = np.load(os.path.join(directory, "datapoint_to_token.npy"))
    labels = combined[0::2]
    soar = combined[1::2].copy()
    has_soar = manifest.get("has_soar", bool((soar >= 0).any()))
    soar = np.where(soar < 0, labels, soar) if has_soar else None
    res_bf16 = opt("bf16_residuals.npy")
    bf16_ds = opt("bf16_dataset.npy")
    params = IndexParams(
        n_lists=manifest["n_lists"], metric=DistanceType(manifest["metric"]),
        partitioning_eta=manifest["partitioning_eta"], soar_lambda=manifest["soar_lambda"],
        spilling=soar is not None, pq_bits=manifest.get("pq_bits", 8),
        bf16_residuals=res_bf16 is not None, reordering_bf16=bf16_ds is not None,
        seed=manifest.get("seed", 0))
    return Index(
        centers=tensor(np.load(os.path.join(directory, "centers.npy"))),
        labels=tensor(labels), soar_labels=tensor(soar),
        codes=tensor(opt("hashed_dataset.npy")), pq_codebooks=tensor(opt("pq_codebook.npy")),
        residuals_bf16=tensor(res_bf16, torch.bfloat16),
        codes_soar=tensor(opt("hashed_dataset_soar.npy")),
        bf16_dataset=None if bf16_ds is None else tensor(bf16_ds.astype(np.int16)).view(
            torch.bfloat16),
        params=params)
