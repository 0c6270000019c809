"""IVF-RaBitQ: inverted file over 1-9 bit RaBitQ codes — port of ``cuvs_tpu.neighbors.ivf_rabitq``.

RaBitQ (SIGMOD'24) as the reference implements it: the residual
``r = x - c`` is randomly rotated; each dimension stores a level
``l in [0, 2^bits)`` whose centred value ``xu = l - (2^bits - 1)/2``
approximates the direction of r (1 bit: the sign grid; more bits add
sign-folded magnitude levels). Per-vector factors make the dot estimator
unbiased: ``f_add = |r|^2 + 2|r|^2 <c_rot, xu>/<r, xu>``,
``f_rescale = -2|r|^2/<r, xu>``, and the L2 estimate is
``f_add + |q - c|^2 + f_rescale * <q_rot, xu>``.

Codes are bit-packed into 32-bit words (``core.bitpack``). Search: coarse
probe selection, then the fused quantized-code scan kernel
(``scan_algo="fused"``, bits <= 8: the decode matrix carries the centred
levels, the estimator is the kernel's epilogue) or a query-major scan with a
running top-k merge. The rotation comes from a ``torch.Generator`` seeded
from ``seed``; it draws other numbers than the reference's ``jax.random``.
"""

from __future__ import annotations

import dataclasses
import functools
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
from cuvs_tpu_torch.neighbors.ivf_pq import _make_rotation
from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.tracing import traced


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Mirrors ivf_rabitq::index_params (ivf_rabitq.hpp:38-85)."""

    n_lists: int = 1024
    bits_per_dim: int = 3
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    max_train_points_per_cluster: int = 256
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "metric", normalize_metric(self.metric))
        if not (1 <= self.bits_per_dim <= 9):
            raise ValueError("bits_per_dim must be in [1, 9]")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Mirrors ivf_rabitq::search_params (ivf_rabitq.hpp:95-107).

    ``compute_dtype`` is the query-major scan's product type. ``scan_algo``:
    "auto" | "query_major" | "cluster_major" | "fused", as
    ``ivf_scan.scan_path`` resolves it with query_major as the fallback:
    "fused" runs the fused quantized-code scan kernel (L2/IP, bits <= 8);
    "auto" picks it for large batches on a CUDA device. RaBitQ has no unfused
    cluster-major scan: "cluster_major" runs query_major, as in the reference
    (ivf_rabitq.py:326-334). ``recall_target`` is accepted for parity;
    selection is exact."""

    n_probes: int = 20
    compute_dtype: object = torch.bfloat16
    recall_target: object = None
    scan_algo: str = "auto"


@dataclasses.dataclass
class Index:
    centers: torch.Tensor  # [n_lists, d]
    center_norms: torch.Tensor  # [n_lists]
    rotation: torch.Tensor  # [d, d] random orthogonal
    centers_rot: torch.Tensor  # [n_lists, d] rotated centers
    sorted_codes: torch.Tensor  # [n + W, ceil(d*bits/32)] int32 packed levels
    sorted_fadd: torch.Tensor  # [n + W] estimator f_add
    sorted_frescale: torch.Tensor  # [n + W] estimator f_rescale
    lists: ivf.SortedLists
    metric: DistanceType = DistanceType.L2Expanded
    window: int = 128
    n_rows: int = 0
    bits_per_dim: int = 3
    # fused-scan serving layout (bits <= 8): the same words transposed to
    # [ceil(d*bits/32), n + W] (ops.ivf_scan.fused_pq_scan mode "rabitq")
    sorted_codes_t: Optional[torch.Tensor] = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def size(self) -> int:
        return self.n_rows

    @property
    def device(self) -> torch.device:
        return self.centers.device


@functools.lru_cache(maxsize=None)
def best_scaling_factor(dim: int, ex_bits: int, n_samples: int = 100, seed: int = 7) -> float:
    """Calibrate the magnitude scaling factor for ex-bit codes.

    Mirrors quantizer_gpu.cu:808-905 (best_rescale_factor averaged over
    random unit vectors): pick t maximizing E[<xu,r̄>/||xu||], the cosine
    between the quantized grid point and the true unit residual, over a
    dense grid of 512 samples of [t_start, t_end]. numpy, as the reference.
    """
    if ex_bits <= 0:
        return 0.0
    rng = np.random.default_rng(seed)
    o = np.abs(rng.standard_normal((n_samples, dim)))
    o /= np.linalg.norm(o, axis=1, keepdims=True)
    max_o = o.max(axis=1)  # [S]
    t_end = ((1 << ex_bits) - 1 + 10) / max_o
    t_start = 0.1 * t_end
    ts = t_start[:, None] + (t_end - t_start)[:, None] * (
        np.arange(512) / 511.0
    )[None, :]  # [S, T]
    code = np.minimum(
        np.floor(ts[:, :, None] * o[:, None, :] + 1e-5), (1 << ex_bits) - 1
    )  # [S, T, dim]
    num = ((code + 0.5) * o[:, None, :]).sum(axis=2)
    den = np.sqrt(dim * 0.25 + (code * code + code).sum(axis=2))
    ip = num / den  # [S, T]
    best_t = ts[np.arange(n_samples), ip.argmax(axis=1)]
    return float(best_t.mean())


def _encode_levels(res: torch.Tensor, bits: int, scale: float):
    """Rotated residuals -> levels l in [0, 2^bits) (sign-folded magnitude
    grid, quantizer_gpu.cu:360-375) and the centred values xu."""
    ex = bits - 1
    sign = res >= 0
    if ex == 0:
        lv = sign.to(torch.int32)
    else:
        rnorm = torch.sqrt(torch.clamp_min((res * res).sum(1, keepdim=True), 1e-30))
        mag = torch.clamp_max(torch.floor(scale * res.abs() / rnorm + 1e-5).to(torch.int32),
                              (1 << ex) - 1)
        lv = torch.where(sign, (1 << ex) + mag, (1 << ex) - 1 - mag)
    xu = lv.float() - ((1 << bits) - 1) / 2.0
    return lv, xu


def _encode(xf, centers, centers_rot, labels, rotation, bits: int):
    """Rows -> (levels [n, d] int32, f_add [n], f_rescale [n]): the rotated
    residuals' levels and the per-vector estimator factors
    (quantizer_gpu.cu:272-292 / :410-425)."""
    res = (xf - centers[labels]) @ rotation.T
    lv, xu = _encode_levels(res, bits, best_scaling_factor(xf.shape[1], bits - 1))
    l2_sqr = (res * res).sum(1)
    denom = (res * xu).sum(1)
    denom = torch.where(denom == 0.0, float("inf"), denom)
    ip_cent = (centers_rot[labels] * xu).sum(1)
    return lv, l2_sqr + 2.0 * l2_sqr * ip_cent / denom, -2.0 * l2_sqr / denom


@traced("ivf_rabitq::build")
def build(dataset, params: Optional[IndexParams] = None, device=None, **kw) -> Index:
    """Train the coarse quantizer, rotate and encode the residuals, sort by list."""
    if params is None:
        params = IndexParams(**kw)
    xf = _on_device(dataset, device).float()
    n, d = xf.shape
    dev = xf.device
    n_lists = min(params.n_lists, n)
    bits = params.bits_per_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(params.seed)

    centers = kmeans_balanced.fit(
        xf, n_lists, kmeans_balanced.BalancedParams(n_clusters=n_lists,
                                                    n_iters=params.kmeans_n_iters,
                                                    seed=params.seed))
    labels = kmeans_balanced.predict(xf, centers)
    rotation = _make_rotation(gen, d, d, True)  # RaBitQ always rotates
    centers_rot = centers @ rotation.T
    lab = labels.long()
    lv, fadd, frescale = _encode(xf, centers, centers_rot, lab, rotation, bits)
    codes = bitpack.pack(lv, bits)
    del lv

    window = ivf.round_window(int(torch.bincount(lab, minlength=n_lists).max()))
    order, lists = ivf.sort_by_label(labels, n_lists, pad=window)

    def pad_rows(a):
        return torch.cat([a[order], a.new_zeros((window,) + a.shape[1:])])

    sorted_codes = pad_rows(codes)
    # fused layout (bits <= 8: book = 2^bits table entries per dimension);
    # no pad of the word rows, the kernel reads words by index
    codes_t = sorted_codes.T.contiguous() if bits <= 8 else None
    return Index(centers=centers, center_norms=pairwise.row_norms(centers), rotation=rotation,
                 centers_rot=centers_rot, sorted_codes=sorted_codes, sorted_codes_t=codes_t,
                 sorted_fadd=pad_rows(fadd), sorted_frescale=pad_rows(frescale), lists=lists,
                 metric=params.metric, window=window, n_rows=int(n), bits_per_dim=bits)


def _search_impl(index: Index, queries, prefilter, k: int, n_probes: int, metric,
                 compute_dtype, recall_target) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-major scan: per probe, unpack the window's levels, estimate,
    and merge into a running top-k."""
    lists, window, bits = index.lists, index.window, index.bits_per_dim
    qf = queries.float()
    nq, d = qf.shape
    probe_ids = ivf.coarse_search(qf, index.centers, index.center_norms, n_probes, metric)
    ip = metric == DistanceType.InnerProduct
    qn = (qf * qf).sum(1)
    qrot = qf @ index.rotation.T
    kb = -((1 << bits) - 1) / 2.0
    kb_sumq = kb * qrot.sum(1)  # [nq] (ivf_gpu.cu:1000-1021)
    qc = qrot.to(compute_dtype).float()

    def score(cluster, starts):
        words_w = ivf.window_gather(index.sorted_codes, starts, window)  # [nq, W, words]
        fadd_w = ivf.window_gather(index.sorted_fadd, starts, window)
        fres_w = ivf.window_gather(index.sorted_frescale, starts, window)
        # levels in the compute type, as the reference's product sees them
        levels = bitpack.unpack(words_w, bits, d).to(compute_dtype).float()
        xu_dot = torch.bmm(levels, qc[:, :, None])[:, :, 0] + kb_sumq[:, None]  # <q_rot, xu>
        qdotc = (qf * index.centers[cluster]).sum(1)
        if ip:
            # <q, x> = <q, c> + a <q_rot, xu>, a = |r|^2/<r, xu> = -f_rescale/2
            return -(qdotc[:, None] + (-0.5 * fres_w) * xu_dot)
        cc = index.centers[cluster]
        g_add = qn + (cc * cc).sum(1) - 2.0 * qdotc
        return torch.clamp_min(fadd_w + g_add[:, None] + fres_w * xu_dot, 0.0)

    best_v, best_i = ivf.query_major_topk(lists, probe_ids, window, k, prefilter,
                                          torch.arange(nq, device=qf.device), score,
                                          recall_target)
    if ip:
        best_v = -best_v
    return ivf.postprocess_distances(best_v, metric), best_i


@traced("ivf_rabitq::search")
def search(index: Index, queries, k: int, params: Optional[SearchParams] = None,
           prefilter: Optional[filt.Prefilter] = None, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate search by the RaBitQ unbiased estimator. Returns
    (distances [nq,k], neighbors [nq,k] global ids int32); pair with
    neighbors.refine for exact re-ranking."""
    if params is None:
        params = SearchParams(**kw)
    if prefilter is None:
        prefilter = filt.no_filter()
    queries = torch.as_tensor(queries, device=index.device)
    nq = queries.shape[0]
    n_probes = min(params.n_probes, index.n_lists)
    fused_ok = index.sorted_codes_t is not None and index.metric in ivf_scan.FUSED_METRICS
    if ivf_scan.scan_path(params.scan_algo, nq, n_probes, index.n_lists, fused_ok,
                          queries.is_cuda, "query_major") == "fused":
        qf = queries.float()
        probe_ids = ivf.coarse_search(qf, index.centers, index.center_norms, n_probes,
                                      index.metric)
        # metric-effective factors (see cluster_major_scan_rabitq_fused)
        if index.metric == DistanceType.InnerProduct:
            fa, fr = torch.zeros_like(index.sorted_fadd), 0.5 * index.sorted_frescale
        else:
            fa, fr = index.sorted_fadd, index.sorted_frescale
        M, n_tiles = ivf_scan.tile_geometry(nq, n_probes, index.n_lists)
        return ivf_scan.cluster_major_scan_rabitq_fused(
            index.sorted_codes_t, fa, fr, index.centers_rot, index.rotation, index.lists, qf,
            probe_ids, int(k), index.metric, index.window, M, n_tiles,
            int(index.bits_per_dim), params.recall_target, prefilter=prefilter)
    return _search_impl(index, queries, prefilter, int(k), int(n_probes), index.metric,
                        params.compute_dtype, params.recall_target)
