"""IVF-PQ: inverted file with product-quantized residuals — port of ``cuvs_tpu.neighbors.ivf_pq``.

Build (ivf_pq_build.cuh): a balanced k-means coarse quantizer, residuals
``x - center`` rotated (identity unless ``rot_dim != dim`` or forced), one
codebook per subspace trained by EM on a subsample, codes
``argmin_c |res_s - codebook[s, c]|``, sorted by list and bit-packed at
``pq_bits`` (``core.bitpack``), plus the fused scan's serving layout
(transposed code bytes and decoded-residual norms). Search: coarse probe
selection, then the fused cluster-major PQ scan kernel (``scan_algo="fused"``)
or a query-major ADC scan over probes with a running top-k merge. Defaults
mirror the reference: n_lists=1024, pq_bits=8, pq_dim=0 (auto), codebooks
PER_SUBSPACE, max_train_points_per_pq_code=256.

Randomness comes from one ``torch.Generator`` seeded from ``seed`` (the
rotation, the training subsample, the codebooks' initial rows); it draws other
numbers than the reference's ``jax.random`` from the same seed.
Not ported yet (``ROADMAP.md`` queue 1 #4): PER_CLUSTER codebooks, ``extend``,
``build_streaming``, and the unfused ``cluster_major`` scan.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cuvs_tpu_torch.cluster import kmeans_balanced
from cuvs_tpu_torch.core import bitpack
from cuvs_tpu_torch.distance import pairwise
from cuvs_tpu_torch.distance.pairwise import DistanceType, normalize_metric
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.selection.select_k import topk
from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.tracing import traced

# transient bound for the chunked residual pass in build() (tests shrink it
# to exercise the chunked path at toy sizes)
_RES_CHUNK_BYTES = 256 << 20
# bound on the [subspaces, rows, book] distance block of codebook training
# and encoding, in elements
_EM_BLOCK = 1 << 28

_FUSED_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                  DistanceType.InnerProduct)
_UNPORTED = "is not ported yet (ROADMAP.md queue 1 #4)"


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

    ``scan_algo``: "auto" | "query_major" | "fused". "fused" runs the fused
    PQ scan kernel (L2/IP, per-subspace codebooks; otherwise query_major).
    "auto" picks fused for large batches (nq * n_probes >= 4 * n_lists) on a
    CUDA device, query_major otherwise. ``lut_dtype=torch.int8`` selects an
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
    pq_centers: torch.Tensor  # [pq_dim, book, pq_len]
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
        xn = (xs * xs).sum(2)[:, :, None].expand(-1, -1, book)
        for _ in range(n_iters):
            # (|x|^2 - 2 x.c) + |c|^2, rounded as the reference's sum is
            d = torch.baddbmm(xn, xs, c.transpose(1, 2), alpha=-2.0).add_((c * c).sum(2)[:, None, :])
            sums, counts = _segment_sums(xs, d.argmin(2), book)
            new = sums / torch.clamp_min(counts, 1.0)[..., None]
            c = torch.where(counts[..., None] > 0, new, c)
        out.append(c)
    return torch.cat(out)


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


@traced("ivf_pq::build")
def build(dataset, params: Optional[IndexParams] = None, device=None, **kw) -> Index:
    """Train the coarse quantizer and the codebooks, encode and sort the rows."""
    if params is None:
        params = IndexParams(**kw)
    if params.codebook_gen != "per_subspace":
        raise NotImplementedError(f"codebook_gen='per_cluster' {_UNPORTED}")
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
    labels = kmeans_balanced.predict(xf, centers)
    rotation = _make_rotation(gen, dim, rot_dim, params.force_random_rotation)
    centers_rot = centers @ rotation.T
    res = _residuals(xf, centers, labels, rotation)
    del xf

    # codebooks from a subsample (max_train_points_per_pq_code * book rows)
    n_train = min(n, params.max_train_points_per_pq_code * book)
    train_idx = torch.randperm(n, generator=gen, device=dev)[:n_train]
    res_train = res[train_idx].reshape(n_train, pq_dim, pq_len).transpose(0, 1).contiguous()
    pq_centers = _train_codebooks(res_train, _init_indices(gen, pq_dim, n_train, book), 25)
    codes = _encode(res, pq_centers)
    del res

    if params.add_data_on_build:
        window = ivf.round_window(int(torch.bincount(labels.long(), minlength=n_lists).max()))
    else:
        # reference semantics: train the quantizer and codebooks only
        codes, labels, n = codes[:0], labels[:0], 0
        window = ivf.round_window(0)
    order, lists = ivf.sort_by_label(labels, n_lists, pad=window)
    cs = codes[order]
    packed = bitpack.pack(cs, params.pq_bits)
    sorted_codes = torch.cat([packed, torch.zeros((window, packed.shape[1]), dtype=torch.int32,
                                                  device=dev)])
    serving_codes = serving_norms = None
    if n > 0:
        from cuvs_tpu_torch.neighbors import ivf_scan

        serving_codes = ivf_scan.pack_codes_transposed(cs, window)
        serving_norms = ivf_scan.decoded_norms(cs, pq_centers, window, window + 128)
    return Index(centers=centers, center_norms=pairwise.row_norms(centers),
                 centers_rot=centers_rot, rotation=rotation, pq_centers=pq_centers,
                 sorted_codes=sorted_codes, lists=lists, metric=params.metric, window=window,
                 n_rows=int(n), pq_bits=params.pq_bits, codebook_gen=params.codebook_gen,
                 pq_dim_static=int(pq_dim), sorted_codes_t=serving_codes,
                 sorted_code_norms=serving_norms)


def build_streaming(*args, **kw) -> Index:
    """Out-of-memory-source build: not ported yet."""
    raise NotImplementedError(f"ivf_pq.build_streaming {_UNPORTED}")


def extend(index: Index, new_vectors, new_ids=None) -> Index:
    """Append vectors: not ported yet."""
    raise NotImplementedError(f"ivf_pq.extend {_UNPORTED}")


def _search_impl(index: Index, queries, prefilter, k: int, n_probes: int, metric, lut_dtype,
                 qchunk: int, recall_target) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-major ADC scan: per query chunk and probe, a lookup table
    [nq, pq_dim, book] in the rotated residual space, a gather-sum over each
    window row's codes, and a running top-k merge."""
    lists = index.lists
    window = index.window
    pq_dim, book, pq_len = index.pq_centers.shape
    ip = metric == DistanceType.InnerProduct
    cbook_norms = (index.pq_centers * index.pq_centers).sum(2)  # [pq_dim, book]
    sub_off = torch.arange(pq_dim, device=index.device) * book

    qf = queries.float()
    probe_all = ivf.coarse_search(qf, index.centers, index.center_norms, n_probes, metric)
    qrot_all = qf @ index.rotation.T
    out_v, out_i = [], []
    for c0 in range(0, qf.shape[0], qchunk):
        q = qf[c0:c0 + qchunk]
        nq = q.shape[0]
        qsub = qrot_all[c0:c0 + qchunk].reshape(nq, pq_dim, pq_len)
        probes = probe_all[c0:c0 + qchunk]
        qid = torch.arange(c0, c0 + nq, device=q.device)
        best_v = torch.full((nq, k), float("inf"), device=q.device)
        best_i = torch.zeros((nq, k), dtype=torch.int32, device=q.device)
        for j in range(n_probes):
            cluster = probes[:, j].long()
            if ip:
                # score = q.center + sum_s q_rot_s . codebook (maximized)
                lut = -torch.einsum("nsl,sbl->nsb", qsub, index.pq_centers)
                base_order = -(q * index.centers[cluster]).sum(1)
            else:
                # |res_s - c|^2 without the per-query |res|^2, added back below
                res = qsub - index.centers_rot[cluster].reshape(nq, pq_dim, pq_len)
                lut = cbook_norms[None] - 2.0 * torch.einsum("nsl,sbl->nsb", res,
                                                             index.pq_centers)
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

            starts = lists.offsets[cluster]
            words_w = ivf.window_gather(index.sorted_codes, starts, window)  # [nq, W, words]
            ids_w = ivf.window_gather(lists.ids, starts, window)
            lab_w = ivf.window_gather(lists.labels, starts, window)
            flat_idx = bitpack.unpack(words_w, index.pq_bits, pq_dim).long() + sub_off
            scores = torch.gather(lut_flat, 1, flat_idx.reshape(nq, -1)).reshape(
                nq, window, pq_dim).sum(-1)
            if lut_scale is not None:
                scores = scores * lut_scale[:, None]
            order = scores + base_order[:, None]
            valid = lab_w == cluster[:, None]
            mask = filt.passes(prefilter, qid[:, None], ids_w)
            if mask is not None:
                valid = valid & mask
            order = torch.where(valid, order, float("inf"))
            tv, tl = topk(order, min(k, window), True, recall_target)
            ti = torch.gather(ids_w, 1, tl)
            best_v, sidx = topk(torch.cat([best_v, tv], 1), k, True)
            best_i = torch.gather(torch.cat([best_i, ti], 1), 1, sidx)
        out_v.append(best_v)
        out_i.append(best_i)
    bv = torch.cat(out_v)
    if ip:
        bv = -bv
    return ivf.postprocess_distances(bv, metric), torch.cat(out_i)


@traced("ivf_pq::search")
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
    n_probes = min(params.n_probes, index.n_lists)
    algo = params.scan_algo
    if algo not in ("auto", "query_major", "fused"):
        raise ValueError(f"scan_algo {algo!r}: the port has auto, query_major and fused "
                         f"(cluster_major {_UNPORTED})")
    fused_ok = (index.sorted_codes_t is not None and index.codebook_gen == "per_subspace"
                and index.metric in _FUSED_METRICS)
    if algo == "auto":
        big = nq * n_probes >= 4 * index.n_lists
        algo = "fused" if big and queries.is_cuda and fused_ok else "query_major"
    if algo == "fused" and not fused_ok:
        algo = "query_major"
    if algo == "fused":
        from cuvs_tpu_torch.neighbors import ivf_scan

        qf = queries.float()
        probe_ids = ivf.coarse_search(qf, index.centers, index.center_norms, n_probes,
                                      index.metric, params.compute_dtype)
        M = int(min(128, max(8, nq)))
        n_tiles = nq * n_probes // M + min(index.n_lists, nq * n_probes) + 1
        return ivf_scan.cluster_major_scan_pq_fused(
            index.sorted_codes_t, index.sorted_code_norms, index.centers_rot, index.pq_centers,
            index.rotation, index.lists, qf, probe_ids, int(k), index.metric, index.window, M,
            int(n_tiles), params.recall_target, bin_cap=int(min(32, max(2, -(-k // 32)))),
            book=int(index.pq_book_size), prefilter=prefilter,
            fused_dtype="int8" if params.lut_dtype == torch.int8 else "bf16")
    qchunk = int(min(params.max_internal_batch_size, max(64, nq)))
    return _search_impl(index, queries, prefilter, int(k), int(n_probes), index.metric,
                        params.lut_dtype, qchunk, params.recall_target)
