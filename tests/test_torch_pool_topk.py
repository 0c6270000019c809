"""The pool merge of the fused IVF searches (``ops.pool_topk``), on the CPU.

The plain version must equal the postludes' earlier sequence (pad the pool
with a +inf tile, gather each query's rows, add the offsets, stable top-k)
and the contract the kernel holds: ascending values, ties to the lower
column, dropped pairs +inf. The postludes built on it must return what they
returned before. Everything here is exact: values and ids are compared bit
for bit.
"""

import numpy as np
import pytest
import torch

from cuvs_tpu_torch.distance.pairwise import DistanceType
from cuvs_tpu_torch.neighbors import filters as filt
from cuvs_tpu_torch.neighbors import ivf_common as ivf
from cuvs_tpu_torch.neighbors import ivf_scan as nb_scan
from cuvs_tpu_torch.ops import pool_topk as ops_pool
from cuvs_tpu_torch.selection.select_k import topk
from torch_parity import pool_case

torch.set_num_threads(1)

# (nq, p, F, fetch): fetch 1 and the widest; an uneven F; the whole pool
SHAPES = [(9, 6, 128, 1), (13, 7, 256, 20), (5, 3, 384, 256), (6, 2, 128, 256),
          (4, 1, 128, 128)]
KINDS = [dict(), dict(tied=True), dict(inf_share=0.6), dict(tied=True, dropped=0.4)]


def _tensors(case):
    return {k: (torch.from_numpy(v) if v is not None else None) for k, v in case.items()}


def _earlier_sequence(out_v, pair_tile, pair_slot, offs, fetch):
    """The postludes' merge before the pool top-k: sentinel tile, gather, offsets, top-k."""
    nq, p = pair_tile.shape
    F = out_v.shape[2]
    out_v = torch.cat([out_v, torch.full((1,) + out_v.shape[1:], float("inf"))])
    pt, ps = pair_tile.long(), pair_slot.long()
    pv = out_v[pt, ps] if offs is None else out_v[pt, ps] + offs[:, :, None]
    return topk(pv.reshape(nq, p * F), fetch, True)


def _contract(out_v, pair_tile, pair_slot, offs, fetch):
    """numpy: the virtual pool's `fetch` smallest by (value, column)."""
    nq, p = pair_tile.shape
    n_tiles, _, F = out_v.shape
    pv = np.full((nq, p, F), np.inf, np.float32)
    kept = pair_tile < n_tiles
    pv[kept] = out_v[pair_tile[kept], pair_slot[kept]]
    if offs is not None:
        pv = pv + offs[:, :, None]
    pv = pv.reshape(nq, p * F)
    cols = np.stack([np.lexsort((np.arange(p * F), row))[:fetch] for row in pv])
    return np.take_along_axis(pv, cols, 1), cols


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", range(len(KINDS)))
@pytest.mark.parametrize("offsets", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_pool_topk_is_the_earlier_sequence(shape, offsets, kind):
    nq, p, F, fetch = shape
    case = pool_case(nq * 31 + kind, nq, p, F, offsets=offsets, **KINDS[kind])
    t = _tensors(case)
    args = (t["out_v"], t["pair_tile"], t["pair_slot"], t["offs"])
    tv, tl = ops_pool.pool_topk(*args, fetch)
    ev, el = _earlier_sequence(*args, fetch)
    assert tv.shape == (nq, min(fetch, p * F)) and tl.dtype == torch.int64
    assert torch.equal(_bits(tv), _bits(ev)) and torch.equal(tl, el)
    cv, cl = _contract(case["out_v"], case["pair_tile"], case["pair_slot"], case["offs"],
                       min(fetch, p * F))
    assert np.array_equal(tv.numpy(), cv) and np.array_equal(tl.numpy(), cl)


def test_plain_pool_topk_counts_no_launch_and_caps_fetch_at_the_pool():
    case = _tensors(pool_case(3, 4, 2, 128))
    before = dict(ops_pool.LAUNCHES)
    tv, tl = ops_pool.pool_topk(case["out_v"], case["pair_tile"], case["pair_slot"], None, 300)
    assert tv.shape == tl.shape == (4, 256)
    assert dict(ops_pool.LAUNCHES) == before


def _earlier_flat_pool(out_v, out_i, pair_tile, pair_slot, al, lists, queries_f32, k, metric,
                       ip, cap, post_filter, bitset_mode, overfetch):
    """The flat fused scan's postlude (``ivf_scan._flat_pool``) as it was
    before the pool top-k."""
    nq, p = pair_tile.shape
    post_mode = post_filter is not None
    Fc = cap * 128
    out_v = torch.cat([out_v, torch.full((1,) + out_v.shape[1:], float("inf"))])
    out_i = torch.cat([out_i, torch.zeros((1,) + out_i.shape[1:], dtype=out_i.dtype)])
    pt, ps = pair_tile.long(), pair_slot.long()
    pv = out_v[pt, ps].reshape(nq, p * Fc)
    po = out_i[pt, ps].reshape(nq, p * Fc)
    kk = min(k, p * Fc)
    fetch = min(p * Fc, max(k * overfetch, k)) if post_mode else kk
    tv, tl = topk(pv, fetch, True)
    ok = torch.isfinite(tv)
    al_pad = torch.cat([al, al.new_zeros(1)])
    tile_sel = torch.gather(pt, 1, tl // Fc)
    off = torch.gather(po, 1, tl).long()
    pos = al_pad[tile_sel] + off * 128 + (tl % Fc) % 128
    fi = torch.where(ok, lists.ids[torch.where(ok, pos, 0)], 0).to(torch.int32)
    if bitset_mode and ip:
        tv = tv * 0.5
    if post_mode:
        qid = torch.arange(nq)
        mask = filt.passes(post_filter, qid[:, None], fi)
        tv = torch.where(ok & mask, tv, float("inf"))
        tv, srt = torch.sort(tv, dim=1, stable=True)
        fi = torch.gather(fi, 1, srt)
        tv, fi = tv[:, :kk], fi[:, :kk]
        ok = torch.isfinite(tv)
    if ip:
        fv = torch.where(ok, -tv, float("-inf"))
    else:
        qn = (queries_f32 * queries_f32).sum(1)
        fv = ivf.postprocess_distances(torch.clamp_min(tv + qn[:, None], 0.0), metric)
    if kk < k:
        fv = torch.nn.functional.pad(fv, (0, k - kk), value=float("-inf") if ip else float("inf"))
        fi = torch.nn.functional.pad(fi, (0, k - kk))
    return fv, fi


def _earlier_pool_with_offsets(out_v, out_i, pair_tile, pair_slot, al, lists, offs, k, metric,
                               ip, cap, post_filter=None, overfetch=4):
    """The quantized fused scans' postlude (``ivf_scan._pool_with_offsets``) as
    it was before the pool top-k."""
    nq, p = pair_tile.shape
    Fc = cap * 128
    out_v = torch.cat([out_v, torch.full((1,) + out_v.shape[1:], float("inf"))])
    out_i = torch.cat([out_i, torch.zeros((1,) + out_i.shape[1:], dtype=out_i.dtype)])
    pt, ps = pair_tile.long(), pair_slot.long()
    pv = (out_v[pt, ps] + offs[:, :, None]).reshape(nq, p * Fc)
    po = out_i[pt, ps].reshape(nq, p * Fc)
    kk = min(k, p * Fc)
    fetch = min(p * Fc, max(k * overfetch, k)) if post_filter is not None else kk
    tv, tl = topk(pv, fetch, True)
    ok = torch.isfinite(tv)
    al_pad = torch.cat([al, al.new_zeros(1)])
    tile_sel = torch.gather(pt, 1, tl // Fc)
    off = torch.gather(po, 1, tl).long()
    pos = al_pad[tile_sel] + off * 128 + (tl % Fc) % 128
    fi = torch.where(ok, lists.ids[torch.where(ok, pos, 0)], 0).to(torch.int32)
    if post_filter is not None:
        qid = torch.arange(nq)
        mask = filt.passes(post_filter, qid[:, None], fi)
        tv = torch.where(ok & mask, tv, float("inf"))
        tv, srt = torch.sort(tv, dim=1, stable=True)
        fi = torch.gather(fi, 1, srt)
        tv, fi = tv[:, :kk], fi[:, :kk]
        ok = torch.isfinite(tv)
    if ip:
        fv = torch.where(ok, -tv, float("-inf"))
    else:
        fv = ivf.postprocess_distances(torch.where(ok, torch.clamp_min(tv, 0.0), float("inf")),
                                       metric)
    if kk < k:
        fv = torch.nn.functional.pad(fv, (0, k - kk), value=float("-inf") if ip else float("inf"))
        fi = torch.nn.functional.pad(fi, (0, k - kk))
    return fv, fi


def _udf_filter():
    return filt.udf_filter(lambda q, ids: (ids % 3 != 0) & (q >= 0))


# (metric, k, post-filter, bitset_mode): k above the pool (padding), the udf
# post-filter's over-fetch, the bitset IP halving
POSTLUDES = [(DistanceType.L2Expanded, 10, False, False),
             (DistanceType.L2SqrtExpanded, 300, False, False),
             (DistanceType.InnerProduct, 16, False, False),
             (DistanceType.InnerProduct, 16, False, True),
             (DistanceType.L2Expanded, 20, True, False)]


@pytest.mark.parametrize("kind", range(len(KINDS)))
@pytest.mark.parametrize("postlude", range(len(POSTLUDES)))
@pytest.mark.parametrize("offsets", [False, True])
def test_postludes_return_what_they_returned(offsets, postlude, kind):
    metric, k, post, bitset_mode = POSTLUDES[postlude]
    nq, p, cap = 7, 2, 1
    case = pool_case(100 + postlude * 7 + kind, nq, p, cap * 128, offsets=True, **KINDS[kind])
    t = _tensors(case)
    n = t["ids"].shape[0]
    lists = ivf.SortedLists(offsets=torch.zeros(1, dtype=torch.int32),
                            sizes=torch.full((1,), n, dtype=torch.int32),
                            labels=torch.zeros(n, dtype=torch.int32), ids=t["ids"])
    ip = metric == DistanceType.InnerProduct
    flt = _udf_filter() if post else None
    common = (t["out_v"], t["out_i"], t["pair_tile"], t["pair_slot"], t["al"], lists)
    # the merge with each scan's finish, as cluster_major_scan_fused and the
    # quantized fused scans call it
    if offsets:
        got = nb_scan._merge_pools(*common, t["offs"], k, metric, cap, flt, 4,
                                   nb_scan._offsets_l2)
        want = _earlier_pool_with_offsets(*common, t["offs"], k, metric, ip, cap,
                                          post_filter=flt, overfetch=4)
    else:
        q = torch.from_numpy(np.random.default_rng(kind).standard_normal((nq, 16))
                             .astype(np.float32))
        got = nb_scan._merge_pools(*common, None, k, metric, cap, flt, 4, nb_scan._flat_l2(q),
                                   halve=ip and bitset_mode)
        want = _earlier_flat_pool(*common, q, k, metric, ip, cap, flt, bitset_mode, 4)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
