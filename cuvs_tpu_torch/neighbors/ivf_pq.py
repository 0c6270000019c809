"""IVF-PQ: inverted file with product-quantized residuals — port of ``cuvs_tpu.neighbors.ivf_pq``.

Build (ivf_pq_build.cuh): a balanced k-means coarse quantizer, residuals
``x - center`` rotated (identity unless ``rot_dim != dim`` or forced), one
codebook per subspace trained by EM on a subsample, codes
``argmin_c |res_s - codebook[s, c]|``, sorted by list and bit-packed at
``pq_bits`` (``core.bitpack``), plus the fused scan's serving layout
(transposed code bytes and decoded-residual norms). PER_CLUSTER codebooks
train one codebook per list on its own rows. ``extend`` appends rows;
``build_streaming`` builds from host slices with only the codes on the card.
Search: coarse probe selection, then the fused cluster-major PQ scan kernel
(``scan_algo="fused"``), the unfused decode-and-dot cluster-major scan
(``"cluster_major"``) or a query-major ADC scan over probes with a running
top-k merge. Defaults mirror the reference: n_lists=1024, pq_bits=8,
pq_dim=0 (auto), codebooks PER_SUBSPACE, max_train_points_per_pq_code=256.

Randomness comes from one ``torch.Generator`` seeded from ``seed`` (the
rotation, the training subsample, the codebooks' initial rows); it draws other
numbers than the reference's ``jax.random`` from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.core import bitpack
from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.neighbors import ivf_scan
from cuvs_tpu_torch.utils import tracing
from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.device import resolve_device

# transient bound for the chunked residual pass in build() (tests shrink it
# to exercise the chunked path at toy sizes)
_RES_CHUNK_BYTES = 256 << 20
# bound on the [subspaces, rows, book] distance block of codebook training
# and encoding, in elements
_EM_BLOCK = 1 << 28

# elements of the unfused cluster-major scan's [C, M, W] block (64 MB of f32)
_CM_BUDGET = 64 * 1024 * 1024 // 4


def calculate_pq_dim(dim: int) -> int:
    """Auto pq_dim heuristic (ivf_pq_index.cu:612-622)."""
    if dim >= 128:
        dim //= 2
    r = (dim // 32) * 32
    if r > 0:
        return r
    r = 1
    while (r << 1) <= dim:
        r <<= 1
    return r


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Mirrors ivf_pq::index_params (ivf_pq.hpp:47-132)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8
    pq_dim: int = 0  # 0 = auto
    codebook_gen: str = "per_subspace"  # or "per_cluster" (ivf_pq.hpp:34)
    force_random_rotation: bool = False
    add_data_on_build: bool = True
    max_train_points_per_pq_code: int = 256
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "metric", normalize_metric(self.metric))
        if not (4 <= self.pq_bits <= 8):
            raise ValueError("pq_bits must be in [4, 8]")
        if self.codebook_gen not in ("per_subspace", "per_cluster"):
            raise ValueError("codebook_gen must be per_subspace or per_cluster")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Mirrors ivf_pq::search_params (ivf_pq.hpp:160-212).

    ``scan_algo``: "auto" | "query_major" | "cluster_major" | "fused", as
    ``ivf_scan.scan_path`` resolves it with cluster_major as the fallback:
    "fused" runs the fused PQ scan kernel (L2/IP, per-subspace codebooks with
    the serving layout); "auto" picks it for large batches on a CUDA device.
    ``lut_dtype=torch.int8`` selects an
    int8 lookup table (the fused kernel's int8 mode, one scale per tile);
    float32/bfloat16 select its bf16 table. ``recall_target`` is accepted
    for parity; selection is exact."""

    n_probes: int = 20
    lut_dtype: object = torch.float32
    internal_distance_dtype: object = torch.float32
    coarse_compute_dtype: object = torch.float32
    max_internal_batch_size: int = 4096
    recall_target: object = None
    compute_dtype: object = torch.float32
    scan_algo: str = "auto"


@dataclasses.dataclass
class Index:
    centers: torch.Tensor  # [n_lists, d]
    center_norms: torch.Tensor  # [n_lists]
    centers_rot: torch.Tensor  # [n_lists, rot_dim]
    rotation: torch.Tensor  # [rot_dim, d] (orthonormal columns)
    pq_centers: torch.Tensor  # PER_SUBSPACE [pq_dim, book, pq_len]; PER_CLUSTER [n_lists, ...]
    sorted_codes: torch.Tensor  # [n + W, ceil(pq_dim*pq_bits/32)] int32 packed words
    lists: ivf.SortedLists
    metric: DistanceType = DistanceType.L2Expanded
    window: int = 128
    n_rows: int = 0
    pq_bits: int = 8
    codebook_gen: str = "per_subspace"
    pq_dim_static: int = 0
    # fused-scan serving layout: code bytes as [ceil(pq_dim/4), n + W] int32
    # words + decoded-residual norms [>= n] (ops.ivf_scan.fused_pq_scan)
    sorted_codes_t: Optional[torch.Tensor] = None
    sorted_code_norms: Optional[torch.Tensor] = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def pq_dim(self) -> int:
        if self.codebook_gen == "per_cluster":
            return self.pq_dim_static
        return self.pq_centers.shape[0]

    @property
    def pq_len(self) -> int:
        return self.pq_centers.shape[2]

    @property
    def pq_book_size(self) -> int:
        return self.pq_centers.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def size(self) -> int:
        return self.n_rows

    @property
    def device(self) -> torch.device:
        return self.centers.device


def _make_rotation(gen: torch.Generator, dim: int, rot_dim: int, force_random: bool
                   ) -> torch.Tensor:
    """[rot_dim, dim] with orthonormal columns; identity unless needed or
    forced (ivf_pq_build.cuh:81-155): QR of the generator's normals."""
    if rot_dim == dim and not force_random:
        return torch.eye(dim, device=gen.device)
    g = torch.randn((max(rot_dim, dim), dim), generator=gen, device=gen.device)
    q, _ = torch.linalg.qr(g)  # [max, dim] orthonormal columns
    if rot_dim <= q.shape[0]:
        return q[:rot_dim].contiguous()
    return torch.nn.functional.pad(q, (0, 0, 0, rot_dim - q.shape[0]))


def _init_indices(gen: torch.Generator, pq_dim: int, n_train: int, book: int) -> torch.Tensor:
    """Initial codebook rows: ``book`` distinct training rows per subspace
    [pq_dim, book] int64."""
    if n_train < book:
        raise ValueError(f"{n_train} training rows cannot seed a codebook of {book}")
    keys = torch.rand((pq_dim, n_train), generator=gen, device=gen.device)
    return torch.argsort(keys, dim=1)[:, :book]


def _segment_sums(xs: torch.Tensor, labels: torch.Tensor, book: int):
    """Per-(subspace, code) sums and counts of xs [S, n, L] by labels [S, n],
    each segment summed in row order (no atomics: reproducible on CUDA)."""
    S, n, L = xs.shape
    key = (labels + torch.arange(S, device=xs.device)[:, None] * book).reshape(-1)
    counts = torch.bincount(key, minlength=S * book)
    srt = torch.argsort(key, stable=True)
    sums = torch.segment_reduce(xs.reshape(S * n, L)[srt], "sum", lengths=counts)
    return sums.reshape(S, book, L), counts.reshape(S, book).float()


def _em(xs: torch.Tensor, c: torch.Tensor, n_iters: int, valid=None) -> torch.Tensor:
    """EM of codebooks c [B, book, L] over xs [B, n, L], batched over B; rows
    with ``valid`` False [B, n] join no code."""
    book = c.shape[1]
    xn = (xs * xs).sum(2)[:, :, None].expand(-1, -1, book)
    for _ in range(n_iters):
        # (|x|^2 - 2 x.c) + |c|^2, rounded as the reference's sum is
        d = torch.baddbmm(xn, xs, c.transpose(1, 2), alpha=-2.0).add_((c * c).sum(2)[:, None, :])
        if valid is None:
            sums, counts = _segment_sums(xs, d.argmin(2), book)
        else:  # invalid rows go to segment ``book``, which is dropped
            sums, counts = _segment_sums(xs, torch.where(valid, d.argmin(2), book), book + 1)
            sums, counts = sums[:, :book], counts[:, :book]
        new = sums / torch.clamp_min(counts, 1.0)[..., None]
        c = torch.where(counts[..., None] > 0, new, c)
    return c


def _train_codebooks(res_sub: torch.Tensor, init_idx: torch.Tensor, n_iters: int
                     ) -> torch.Tensor:
    """EM over all subspaces at once (the reference vmaps it).

    res_sub [pq_dim, n_train, pq_len] residual subvectors; init_idx
    [pq_dim, book] initial rows. Returns [pq_dim, book, pq_len]."""
    S, n, L = res_sub.shape
    book = init_idx.shape[1]
    out = []
    step = max(1, _EM_BLOCK // max(1, n * book))
    for s0 in range(0, S, step):
        xs = res_sub[s0:s0 + step]
        c = torch.gather(xs, 1, init_idx[s0:s0 + step, :, None].expand(-1, book, L))
        out.append(_em(xs, c, n_iters))
    return torch.cat(out)


def _init_indices_per_cluster(gen: torch.Generator, sizes: torch.Tensor, train_w: int,
                              pq_dim: int, book: int) -> torch.Tensor:
    """Initial codebook rows per list [n_lists, book] int64: uniform draws,
    with replacement, among the subvectors of the list's first
    min(size, train_w) rows."""
    bound = (torch.clamp(sizes.long(), 1, train_w) * pq_dim)[:, None]
    u = torch.rand((sizes.shape[0], book), generator=gen, device=gen.device)
    return torch.minimum((u * bound).long(), bound - 1)


def _train_codebooks_per_cluster(sorted_res: torch.Tensor, offsets: torch.Tensor,
                                 sizes: torch.Tensor, init_idx: torch.Tensor, n_iters: int,
                                 train_w: int) -> torch.Tensor:
    """PER_CLUSTER codebooks (train_per_cluster, ivf_pq_build.cuh:410): one
    [book, pq_len] codebook per list, a masked EM over all subvectors of the
    list's first ``train_w`` rows (rows past the list's size join no code).

    sorted_res [n + pad, pq_dim, pq_len] residual subvectors in list order;
    init_idx [n_lists, book]. Lists are batched so the [lists, subvectors,
    book] distance block stays within _EM_BLOCK elements. Returns
    [n_lists, book, pq_len]."""
    n_lists = offsets.shape[0]
    _, pq_dim, L = sorted_res.shape
    book = init_idx.shape[1]
    T = train_w * pq_dim
    dev = sorted_res.device
    row_of = torch.arange(train_w, device=dev).repeat_interleave(pq_dim)  # [T]
    step = max(1, _EM_BLOCK // max(1, T * book))
    out = []
    for c0 in range(0, n_lists, step):
        start = torch.clamp(offsets[c0:c0 + step].long(), 0, sorted_res.shape[0] - train_w)
        xs = sorted_res[start[:, None] + torch.arange(train_w, device=dev)].reshape(-1, T, L)
        valid = row_of[None, :] < torch.clamp_max(sizes[c0:c0 + step].long(), train_w)[:, None]
        c = torch.gather(xs, 1, init_idx[c0:c0 + step, :, None].expand(-1, book, L))
        out.append(_em(xs, c, n_iters, valid))
    return torch.cat(out)


def _encode_per_cluster(residuals_rot: torch.Tensor, labels: torch.Tensor,
                        pq_centers: torch.Tensor) -> torch.Tensor:
    """residuals_rot [n, rot_dim], labels [n] -> codes [n, pq_dim] uint8,
    each row against its own list's codebook."""
    n = residuals_rot.shape[0]
    _, book, pq_len = pq_centers.shape
    pq_dim = residuals_rot.shape[1] // pq_len
    cnorm = (pq_centers * pq_centers).sum(2)  # [n_lists, book]
    codes = torch.empty((n, pq_dim), dtype=torch.uint8, device=residuals_rot.device)
    chunk = max(1, _EM_BLOCK // (pq_dim * book))
    for c0 in range(0, n, chunk):
        rc = residuals_rot[c0:c0 + chunk].reshape(-1, pq_dim, pq_len)
        lc = labels[c0:c0 + chunk].long()
        d = cnorm[lc][:, None, :] - 2.0 * torch.bmm(rc, pq_centers[lc].transpose(1, 2))
        codes[c0:c0 + chunk] = d.argmin(2).to(torch.uint8)
    return codes


def _encode(residuals_rot: torch.Tensor, pq_centers: torch.Tensor) -> torch.Tensor:
    """residuals_rot [n, rot_dim] -> codes [n, pq_dim] uint8 (nearest codebook
    row per subspace; |res_s|^2 is constant per row and left out)."""
    n = residuals_rot.shape[0]
    pq_dim, book, pq_len = pq_centers.shape
    cnorm = (pq_centers * pq_centers).sum(2)[:, None, :]  # [pq_dim, 1, book]
    cb_t = pq_centers.transpose(1, 2)
    codes = torch.empty((n, pq_dim), dtype=torch.uint8, device=residuals_rot.device)
    chunk = max(1, _EM_BLOCK // (pq_dim * book))
    for c0 in range(0, n, chunk):
        rc = residuals_rot[c0:c0 + chunk].reshape(-1, pq_dim, pq_len).transpose(0, 1)
        # |c|^2 - 2 r.c per subspace [pq_dim, rows, book]
        d = torch.baddbmm(cnorm.expand(-1, rc.shape[1], -1), rc, cb_t, alpha=-2.0)
        codes[c0:c0 + chunk] = d.argmin(2).T.to(torch.uint8)
    return codes


def _residuals(xf, centers, labels, rotation) -> torch.Tensor:
    """(x - center) @ R.T in row chunks of at most _RES_CHUNK_BYTES of f32,
    written into one output: no full-size center gather exists at once."""
    n, dim = xf.shape
    res = torch.empty((n, rotation.shape[0]), dtype=torch.float32, device=xf.device)
    blk = max(128, _RES_CHUNK_BYTES // max(4 * dim, 1) // 128 * 128)
    for s in range(0, n, blk):
        res[s:s + blk] = (xf[s:s + blk] - centers[labels[s:s + blk].long()]) @ rotation.T
    return res


def _sorted_arrays(codes_sorted: torch.Tensor, window: int, pq_centers, pq_bits: int,
                   serving: bool):
    """Packed list-sorted codes [n + window, words] and, with ``serving``,
    the fused scan's layout (``pack_codes_transposed``, ``decoded_norms``)."""
    packed = bitpack.pack(codes_sorted, pq_bits)
    sorted_codes = torch.cat([packed, packed.new_zeros((window, packed.shape[1]))])
    if not serving:
        return sorted_codes, None, None
    return (sorted_codes, ivf_scan.pack_codes_transposed(codes_sorted, window),
            ivf_scan.decoded_norms(codes_sorted, pq_centers, window, window + 128))


@tracing.traced("ivf_pq::build")
def build(dataset, params: Optional[IndexParams] = None, device=None, **kw) -> Index:
    """Train the coarse quantizer and the codebooks, encode and sort the rows."""
    if params is None:
        params = IndexParams(**kw)
    dataset = _on_device(dataset, device)
    n, dim = dataset.shape
    dev = dataset.device
    n_lists = min(params.n_lists, n)
    pq_dim = params.pq_dim or calculate_pq_dim(dim)
    pq_len = -(-dim // pq_dim)
    rot_dim = pq_dim * pq_len
    book = 1 << params.pq_bits
    gen = torch.Generator(device=dev)
    gen.manual_seed(params.seed)

    xf = dataset.float()
    centers = kmeans_balanced.fit(
        xf, n_lists,
        kmeans_balanced.BalancedParams(n_clusters=n_lists, n_iters=params.kmeans_n_iters,
                                       trainset_fraction=params.kmeans_trainset_fraction,
                                       seed=params.seed))
    with tracing.span("ivf_pq::assign"):
        labels = kmeans_balanced.predict(xf, centers)
        rotation = _make_rotation(gen, dim, rot_dim, params.force_random_rotation)
        centers_rot = centers @ rotation.T
        res = _residuals(xf, centers, labels, rotation)
        del xf
        window = ivf.round_window(int(torch.bincount(labels.long(), minlength=n_lists).max()))
        order, lists = ivf.sort_by_label(labels, n_lists, pad=window)

    if params.codebook_gen == "per_cluster":
        with tracing.span("ivf_pq::codebooks"):
            sorted_res = torch.cat([res[order], res.new_zeros((window, rot_dim))]).reshape(
                -1, pq_dim, pq_len)
            train_w = min(window, max(book, params.max_train_points_per_pq_code * book
                                      // max(pq_dim, 1)))
            init = _init_indices_per_cluster(gen, lists.sizes, train_w, pq_dim, book)
            pq_centers = _train_codebooks_per_cluster(sorted_res, lists.offsets, lists.sizes,
                                                      init, 25, train_w)
            del sorted_res
        with tracing.span("ivf_pq::encode"):
            codes = _encode_per_cluster(res, labels, pq_centers)
    else:
        with tracing.span("ivf_pq::codebooks"):
            # codebooks from a subsample (max_train_points_per_pq_code * book rows)
            n_train = min(n, params.max_train_points_per_pq_code * book)
            train_idx = torch.randperm(n, generator=gen, device=dev)[:n_train]
            res_train = res[train_idx].reshape(n_train, pq_dim, pq_len).transpose(
                0, 1).contiguous()
            pq_centers = _train_codebooks(res_train, _init_indices(gen, pq_dim, n_train, book),
                                          25)
        with tracing.span("ivf_pq::encode"):
            codes = _encode(res, pq_centers)
    del res

    with tracing.span("ivf_pq::pack"):
        if not params.add_data_on_build:
            # reference semantics: train the quantizer and codebooks only
            codes, n = codes[:0], 0
            window = ivf.round_window(0)
            order, lists = ivf.sort_by_label(labels[:0], n_lists, pad=window)
        sorted_codes, serving_codes, serving_norms = _sorted_arrays(
            codes[order], window, pq_centers, params.pq_bits,
            params.codebook_gen == "per_subspace" and n > 0)
        return Index(centers=centers, center_norms=pairwise.row_norms(centers),
                     centers_rot=centers_rot, rotation=rotation, pq_centers=pq_centers,
                     sorted_codes=sorted_codes, lists=lists, metric=params.metric,
                     window=window, n_rows=int(n), pq_bits=params.pq_bits,
                     codebook_gen=params.codebook_gen, pq_dim_static=int(pq_dim),
                     sorted_codes_t=serving_codes, sorted_code_norms=serving_norms)


def _gather_codes(codes: torch.Tensor, order: torch.Tensor, window: int, chunk: int = 1 << 20
                  ) -> torch.Tensor:
    """codes[order] followed by ``window`` zero rows, gathered in row chunks."""
    n = order.shape[0]
    out = codes.new_zeros((n + window, codes.shape[1]))
    for r0 in range(0, n, chunk):
        out[r0:min(r0 + chunk, n)] = codes[order[r0:r0 + chunk]]
    return out


def _pack_chunked(codes_u8: torch.Tensor, bits: int, chunk: int = 1 << 20) -> torch.Tensor:
    """bitpack.pack in row chunks (its int64 transient is 8x the codes)."""
    n, S = codes_u8.shape
    out = torch.empty((n, bitpack.packed_words(S, bits)), dtype=torch.int32,
                      device=codes_u8.device)
    for r0 in range(0, n, chunk):
        out[r0:r0 + chunk] = bitpack.pack(codes_u8[r0:r0 + chunk], bits)
    return out


def _codes_t_chunked(sorted_u8: torch.Tensor, chunk: int = 1 << 20) -> torch.Tensor:
    """``ivf_scan.pack_codes_transposed`` in row chunks; the input already
    carries its window of zero rows. No pad of the word rows."""
    n_pad, S = sorted_u8.shape
    out = torch.empty((-(-S // 4), n_pad), dtype=torch.int32, device=sorted_u8.device)
    for r0 in range(0, n_pad, chunk):
        out[:, r0:r0 + chunk] = bitpack.pack(sorted_u8[r0:r0 + chunk], 8).T
    return out


def build_streaming(slice_provider, n_slices: int, n_lists: int = 16384,
                    pq_dim: Optional[int] = None, pq_bits: int = 8,
                    metric: DistanceType = DistanceType.L2Expanded, trainset_rows: int = 2_000_000,
                    kmeans_n_iters: int = 10, seed: int = 0, serving_layout: bool = True,
                    device=None) -> Index:
    """IVF-PQ build from host slices (PER_SUBSPACE codebooks): the f32 source
    exists on the card one slice at a time, and only the uint8 codes stay.

    ``slice_provider(i) -> [rows, d]`` host numpy array, called up to 3 times
    per slice. The quantizer and codebooks train on a strided subsample; each
    slice is uploaded once for labeling and encoding. The index lives on
    ``device`` (None: the card). ``serving_layout=False`` skips the fused
    scan's layout (then searches go through the unfused scans)."""
    metric = normalize_metric(metric)
    if metric not in ivf_scan.FUSED_METRICS:
        raise ValueError("build_streaming supports L2/IP metrics")
    dev = resolve_device(device)
    d = int(np.asarray(slice_provider(0)).shape[1])
    pq_dim = pq_dim or calculate_pq_dim(d)
    pq_len = -(-d // pq_dim)
    rot_dim = pq_dim * pq_len
    book = 1 << pq_bits
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    # pass 0: a strided subsample trains the quantizer, rotation and codebooks
    sub = []
    for i in range(n_slices):
        sl = np.asarray(slice_provider(i), np.float32)
        sub.append(sl[::max(1, sl.shape[0] * n_slices // trainset_rows)])
    trainset = torch.from_numpy(np.concatenate(sub)[:trainset_rows]).to(dev)
    del sub
    centers = kmeans_balanced.fit(
        trainset, n_lists,
        kmeans_balanced.BalancedParams(n_clusters=n_lists, n_iters=kmeans_n_iters,
                                       trainset_fraction=1.0, seed=seed))
    rotation = _make_rotation(gen, d, rot_dim, False)
    centers_rot = centers @ rotation.T
    res_t = _residuals(trainset, centers, kmeans_balanced.predict(trainset, centers), rotation)
    n_train = min(res_t.shape[0], 256 * book)
    idx_t = torch.randperm(res_t.shape[0], generator=gen, device=dev)[:n_train]
    res_train = res_t[idx_t].reshape(n_train, pq_dim, pq_len).transpose(0, 1).contiguous()
    pq_centers = _train_codebooks(res_train, _init_indices(gen, pq_dim, n_train, book), 25)
    del trainset, res_t, res_train

    # pass 1: label and encode each slice; its codes stay on the card
    labels_h, codes_dev = [], []
    for i in range(n_slices):
        sl = torch.from_numpy(np.asarray(slice_provider(i), np.float32)).to(dev)
        lab = kmeans_balanced.predict(sl, centers)
        codes_dev.append(_encode(_residuals(sl, centers, lab, rotation), pq_centers))
        labels_h.append(lab.cpu().numpy())
        del sl
    labels_all = np.concatenate(labels_h).astype(np.int64)
    n = int(labels_all.shape[0])
    sizes = np.bincount(labels_all, minlength=n_lists)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    window = ivf.round_window(int(sizes.max()))
    order = np.argsort(labels_all, kind="stable")

    # assembly: chunked gather into list order, then the packed layouts
    codes = torch.cat(codes_dev)
    del codes_dev
    sorted_u8 = _gather_codes(codes, torch.from_numpy(order).to(dev), window)
    del codes
    sorted_codes = _pack_chunked(sorted_u8, pq_bits)
    serving_codes = serving_norms = None
    if serving_layout:
        serving_codes = _codes_t_chunked(sorted_u8)
        serving_norms = ivf_scan.decoded_norms(sorted_u8[:n], pq_centers, window, window + 128)
    del sorted_u8
    lists = ivf.SortedLists(
        offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
        sizes=torch.from_numpy(sizes.astype(np.int32)).to(dev),
        labels=torch.from_numpy(np.pad(labels_all[order].astype(np.int32), (0, window),
                                       constant_values=-1)).to(dev),
        ids=torch.from_numpy(np.pad(order.astype(np.int32), (0, window))).to(dev))
    return Index(centers=centers, center_norms=pairwise.row_norms(centers),
                 centers_rot=centers_rot, rotation=rotation, pq_centers=pq_centers,
                 sorted_codes=sorted_codes, lists=lists, metric=metric, window=window, n_rows=n,
                 pq_bits=pq_bits, codebook_gen="per_subspace", pq_dim_static=int(pq_dim),
                 sorted_codes_t=serving_codes, sorted_code_norms=serving_norms)


def extend(index: Index, new_vectors, new_ids=None) -> Index:
    """Append vectors: label them, encode their residuals, re-sort the lists
    (and rebuild the serving layout of a per-subspace index)."""
    xf = _on_device(new_vectors, index.device).float()
    n_old, n_new = index.n_rows, xf.shape[0]
    if new_ids is None:
        new_ids = torch.arange(n_old, n_old + n_new, dtype=torch.int32, device=index.device)
    labels_new = kmeans_balanced.predict(xf, index.centers)
    res = _residuals(xf, index.centers, labels_new, index.rotation)
    per_cluster = index.codebook_gen == "per_cluster"
    codes_new = (_encode_per_cluster(res, labels_new, index.pq_centers) if per_cluster
                 else _encode(res, index.pq_centers))
    old_codes = bitpack.unpack(index.sorted_codes[:n_old], index.pq_bits,
                               index.pq_dim).to(torch.uint8)
    all_codes = torch.cat([old_codes, codes_new])
    all_ids = torch.cat([index.lists.ids[:n_old],
                         torch.as_tensor(new_ids, device=index.device).to(torch.int32)])
    all_labels = torch.cat([index.lists.labels[:n_old], labels_new.to(torch.int32)])
    window = ivf.round_window(int(torch.bincount(all_labels.long(),
                                                 minlength=index.n_lists).max()))
    order, lists = ivf.sort_by_label(all_labels, index.n_lists, pad=window)
    lists = lists._replace(ids=torch.cat([all_ids[order], all_ids.new_zeros(window)]))
    sorted_codes, serving_codes, serving_norms = _sorted_arrays(
        all_codes[order], window, index.pq_centers, index.pq_bits, not per_cluster)
    return dataclasses.replace(index, sorted_codes=sorted_codes, lists=lists, window=window,
                               n_rows=n_old + n_new, sorted_codes_t=serving_codes,
                               sorted_code_norms=serving_norms)


def _search_impl(index: Index, queries, prefilter, k: int, n_probes: int, metric, lut_dtype,
                 qchunk: int, recall_target) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-major ADC scan: per query chunk and probe, a lookup table
    [nq, pq_dim, book] in the rotated residual space, a gather-sum over each
    window row's codes, and a running top-k merge."""
    lists = index.lists
    window = index.window
    pq_dim, book, pq_len = index.pq_dim, index.pq_book_size, index.pq_len
    per_cluster = index.codebook_gen == "per_cluster"
    ip = metric == DistanceType.InnerProduct
    cbook_norms = (index.pq_centers * index.pq_centers).sum(2)  # [pq_dim | n_lists, book]
    sub_off = torch.arange(pq_dim, device=index.device) * book

    qf = queries.float()
    probe_all = ivf.coarse_search(qf, index.centers, index.center_norms, n_probes, metric)
    qrot_all = qf @ index.rotation.T
    out_v, out_i = [], []
    for c0 in range(0, qf.shape[0], qchunk):
        q = qf[c0:c0 + qchunk]
        nq = q.shape[0]
        qsub = qrot_all[c0:c0 + qchunk].reshape(nq, pq_dim, pq_len)

        def score(cluster, starts):
            if per_cluster:  # the probed list's own codebook per query
                cb, cb_spec = index.pq_centers[cluster], "nbl"
                cb_norm = cbook_norms[cluster][:, None]
            else:
                cb, cb_spec, cb_norm = index.pq_centers, "sbl", cbook_norms[None]
            if ip:
                # score = q.center + sum_s q_rot_s . codebook (maximized)
                lut = -torch.einsum(f"nsl,{cb_spec}->nsb", qsub, cb)
                base_order = -(q * index.centers[cluster]).sum(1)
            else:
                # |res_s - c|^2 without the per-query |res|^2, added back below
                res = qsub - index.centers_rot[cluster].reshape(nq, pq_dim, pq_len)
                lut = cb_norm - 2.0 * torch.einsum(f"nsl,{cb_spec}->nsb", res, cb)
                base_order = (res * res).sum((1, 2))
            lut_scale = None
            if lut_dtype == torch.int8:
                # scaled 8-bit table (reference lut_dtype = CUDA_R_8U): one
                # scale per query, restored after the gather-sum
                lut_scale = torch.clamp_min(lut.abs().amax((1, 2)), 1e-30) / 127.0
                lut = torch.round(lut / lut_scale[:, None, None])
            else:
                lut = lut.to(lut_dtype)
            lut_flat = lut.reshape(nq, pq_dim * book).float()
            words_w = ivf.window_gather(index.sorted_codes, starts, window)  # [nq, W, words]
            flat_idx = bitpack.unpack(words_w, index.pq_bits, pq_dim).long() + sub_off
            scores = torch.gather(lut_flat, 1, flat_idx.reshape(nq, -1)).reshape(
                nq, window, pq_dim).sum(-1)
            if lut_scale is not None:
                scores = scores * lut_scale[:, None]
            return scores + base_order[:, None]

        best_v, best_i = ivf.query_major_topk(
            lists, probe_all[c0:c0 + qchunk], window, k, prefilter,
            torch.arange(c0, c0 + nq, device=q.device), score, recall_target)
        out_v.append(best_v)
        out_i.append(best_i)
    bv = torch.cat(out_v)
    if ip:
        bv = -bv
    return ivf.postprocess_distances(bv, metric), torch.cat(out_i)


@tracing.traced("ivf_pq::search")
def search(index: Index, queries, k: int, params: Optional[SearchParams] = None,
           prefilter: Optional[filt.Prefilter] = None, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search over PQ codes (approximate distances). Returns (distances
    [nq,k], neighbors [nq,k] global ids int32). Use neighbors.refine for
    exact re-ranking."""
    if params is None:
        params = SearchParams(**kw)
    if prefilter is None:
        prefilter = filt.no_filter()
    queries = torch.as_tensor(queries, device=index.device)
    nq = queries.shape[0]
    tracing.count("queries", nq)
    n_probes = min(params.n_probes, index.n_lists)
    fused_ok = (index.sorted_codes_t is not None and index.codebook_gen == "per_subspace"
                and index.metric in ivf_scan.FUSED_METRICS)
    algo = ivf_scan.scan_path(params.scan_algo, nq, n_probes, index.n_lists, fused_ok,
                              queries.is_cuda, "cluster_major")
    if algo == "query_major":
        qchunk = int(min(params.max_internal_batch_size, max(64, nq)))
        return _search_impl(index, queries, prefilter, int(k), int(n_probes), index.metric,
                            params.lut_dtype, qchunk, params.recall_target)
    qf = queries.float()
    probe_ids = ivf.coarse_search(qf, index.centers, index.center_norms, n_probes,
                                  index.metric, params.compute_dtype)
    if algo == "fused":
        M, n_tiles = ivf_scan.tile_geometry(nq, n_probes, index.n_lists)
        return ivf_scan.cluster_major_scan_pq_fused(
            index.sorted_codes_t, index.sorted_code_norms, index.centers_rot, index.pq_centers,
            index.rotation, index.lists, qf, probe_ids, int(k), index.metric, index.window, M,
            n_tiles, params.recall_target, book=int(index.pq_book_size), prefilter=prefilter,
            fused_dtype="int8" if params.lut_dtype == torch.int8 else "bf16")
    # slots per list: the actual largest occupancy, so no pair drops
    M = min(nq, -(-int(ivf_scan.max_occupancy(probe_ids, index.n_lists)) // 8) * 8)
    chunk = max(1, min(index.n_lists, _CM_BUDGET // max(M * index.window, 1)))
    # 128-position bin selection, cap sized so a list's capacity clears ~2k
    eff = max(1, index.n_rows // index.n_lists // 128)
    bin_cap = int(min(k, 32, max(2, -(-2 * k // eff))))
    return ivf_scan.cluster_major_scan_pq(
        index.sorted_codes, index.centers, index.centers_rot, index.pq_centers, index.rotation,
        index.lists, qf, probe_ids, prefilter, int(k), index.metric, index.window, int(M),
        int(chunk), params.compute_dtype, params.recall_target, int(index.pq_bits),
        index.codebook_gen, int(index.pq_dim), bin_cap)
