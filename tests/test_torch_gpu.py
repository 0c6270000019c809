"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: float32 and bfloat16 pools are compared at rtol 1e-5 / atol 1e-4
(the kernel and the plain version sum the same exact products in another
order; the IVF scan at GIST's width, dp = 960, allows atol 1e-4 * dp / 128);
int8 pools are integer arithmetic and must be identical. Ids must be
equal except where two candidates' values tie within that tolerance. The
quantized-code scan sums every score in one order with its plain version, so
its pools are bit-identical with a bf16 table; with an int8 table they may
differ where an entry's lut/scale sits on a rounding boundary: at most 0.1%
of its pool entries.
"""

import numpy as np
import pytest
import torch

from cuvs_tpu_torch.neighbors import ivf_scan as nb_ivf_scan
from cuvs_tpu_torch.ops import bf_topk, ivf_scan
# pytest puts this directory on sys.path; "tests" itself may name another
# installed package where JAX is absent
from torch_parity import ids_match_modulo_ties, pq_scan_case

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(rng, n, d, dtype, dev):
    x = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == torch.int8:
        return torch.from_numpy(np.clip(np.round(x * 30), -127, 127).astype(np.int8)).to(dev)
    return torch.from_numpy(x).to(dtype).to(dev)


def _assert_pool(kv, ki, rv, ri, exact_ints):
    kv, ki, rv, ri = (t.cpu() for t in (kv, ki, rv, ri))
    if exact_ints:
        assert torch.equal(kv, rv)
        assert torch.equal(ki, ri)
        return
    torch.testing.assert_close(kv, rv, rtol=RTOL, atol=ATOL)
    differ = ki != ri
    # an id may differ only where its value ties another candidate's
    assert differ.float().mean() < 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("k,tile_n", [(1, 2048), (10, 1000), (64, 512)])
def test_exact_kernel_matches_plain(cuda, dtype, ip, k, tile_n):
    rng = np.random.default_rng(k + tile_n)
    q = _data(rng, 70, 128, dtype, cuda)
    x = _data(rng, 5001, 128, dtype, cuda)  # N not a multiple of tile_n
    qn, dn = (t.float().pow(2).sum(1) for t in (q, x))
    kv, ki = bf_topk.bf_topk_exact(q, x, qn, dn, k, tile_n, ip)
    torch.cuda.synchronize()
    rv, ri = bf_topk.bf_topk_exact_reference(q, x, qn, dn, k, tile_n, ip)
    _assert_pool(kv, ki, rv, ri, exact_ints=False)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 128),
                                     (torch.int8, 16), (torch.int8, 256), (torch.float32, 256)])
@pytest.mark.parametrize("ip", [False, True])
def test_approx_kernel_matches_plain(cuda, dtype, d, ip):
    rng = np.random.default_rng(d)
    q = _data(rng, 130, d, dtype, cuda)
    x = _data(rng, 40000, d, dtype, cuda)
    tile_n = 16384
    n_tiles = -(-x.shape[0] // tile_n)
    key_pack = dtype == torch.int8 and 4 * d * 16129 * 256 < 2 ** 31
    pen = bf_topk._penalty(x, None, n_tiles, tile_n, ip, key_pack)
    kv, ki = bf_topk.bf_topk_approx(q, x, pen, tile_n, key_pack)
    torch.cuda.synchronize()
    rv, ri = bf_topk.bf_topk_approx_reference(q, x, pen, tile_n, key_pack)
    _assert_pool(kv, ki, rv, ri, exact_ints=dtype == torch.int8)


def _int_valued(rng, n, d, dtype, dev, dup=1):
    """Small integers in any dtype: every product and sum is exact, so kernel
    and plain version agree bit for bit. dup > 1 repeats each row dup times
    (shuffled), so distances tie exactly."""
    x = rng.integers(-8, 9, (-(-n // dup), d))
    x = np.repeat(x, dup, axis=0)[:n]
    x = x[rng.permutation(n)]
    return torch.from_numpy(x.astype(np.float32)).to(dtype).to(dev).contiguous()


# d around the tensor-core chunk (128 bytes: 64 bf16, 128 int8), ragged, and
# wide (GIST's 960); B around the query block; N a multiple of neither 128 nor
# tile_n, with a last tile of 50 rows out of 1000
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("d,B", [(16, 1), (100, 70), (130, 130), (256, 300), (960, 70)])
def test_exact_kernel_edge_shapes(cuda, dtype, ip, d, B):
    rng = np.random.default_rng(d + B)
    q = _data(rng, B, d, dtype, cuda)
    x = _data(rng, 2050, d, dtype, cuda)
    qn, dn = (t.float().pow(2).sum(1) for t in (q, x))
    kv, ki = bf_topk.bf_topk_exact(q, x, qn, dn, 10, 1000, ip)
    torch.cuda.synchronize()
    rv, ri = bf_topk.bf_topk_exact_reference(q, x, qn, dn, 10, 1000, ip)
    _assert_pool(kv, ki, rv, ri, exact_ints=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_exact_kernel_ties_go_to_the_lowest_column(cuda, dtype, ip, k):
    rng = np.random.default_rng(k)
    q = _int_valued(rng, 130, 100, dtype, cuda)
    x = _int_valued(rng, 3001, 100, dtype, cuda, dup=7)
    qn, dn = (t.float().pow(2).sum(1) for t in (q, x))
    kv, ki = bf_topk.bf_topk_exact(q, x, qn, dn, k, 512, ip)
    torch.cuda.synchronize()
    rv, ri = bf_topk.bf_topk_exact_reference(q, x, qn, dn, k, 512, ip)
    _assert_pool(kv, ki, rv, ri, exact_ints=True)


# d = 130 is the widest int8 key-pack row, 131 the narrowest compare/select
# chain; 960 (GIST) and 2048 need the narrower query blocks; the last of three
# 16384-row tiles holds 300 rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("d,B", [(16, 1), (100, 70), (130, 130), (131, 300), (256, 70),
                                 (960, 130), (2048, 1)])
def test_approx_kernel_edge_shapes(cuda, dtype, ip, d, B):
    rng = np.random.default_rng(d + B)
    q = _data(rng, B, d, dtype, cuda)
    x = _data(rng, 2 * 16384 + 300, d, dtype, cuda)
    tile_n = 16384
    key_pack = dtype == torch.int8 and 4 * d * 16129 * 256 < 2 ** 31
    assert key_pack == (dtype == torch.int8 and d <= 130)
    pen = bf_topk._penalty(x, None, 3, tile_n, ip, key_pack)
    kv, ki = bf_topk.bf_topk_approx(q, x, pen, tile_n, key_pack)
    torch.cuda.synchronize()
    rv, ri = bf_topk.bf_topk_approx_reference(q, x, pen, tile_n, key_pack)
    _assert_pool(kv, ki, rv, ri, exact_ints=dtype == torch.int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("d", [100, 131])
def test_approx_kernel_ties_pick_the_reference_slice(cuda, dtype, ip, d):
    # float and chain: the lowest slice of a tie; key-pack: the highest
    rng = np.random.default_rng(d)
    q = _int_valued(rng, 70, d, dtype, cuda)
    x = _int_valued(rng, 20000, d, dtype, cuda, dup=5)
    tile_n = 8192
    key_pack = dtype == torch.int8 and 4 * d * 16129 * 256 < 2 ** 31
    pen = bf_topk._penalty(x, None, 3, tile_n, ip, key_pack)
    kv, ki = bf_topk.bf_topk_approx(q, x, pen, tile_n, key_pack)
    torch.cuda.synchronize()
    rv, ri = bf_topk.bf_topk_approx_reference(q, x, pen, tile_n, key_pack)
    _assert_pool(kv, ki, rv, ri, exact_ints=True)


# rows and queries: one dtype, bf16 rows with f32 queries (bf16 storage
# searched at f32 compute), or f32 rows with bf16 queries
@pytest.mark.parametrize("dtype,qdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.int8, torch.int8),
                                          (torch.bfloat16, torch.float32),
                                          (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("cap", [2, 3])
def test_ivf_scan_kernel_matches_plain(cuda, dtype, qdtype, ip, cap):
    rng = np.random.default_rng(cap)
    n_pad, dp, nq, M, W = 4096, 128, 50, 100, 1024
    x = _data(rng, n_pad, dp, dtype, cuda)
    q = _data(rng, nq, dp, qdtype, cuda)
    norms = torch.from_numpy(rng.uniform(50, 150, n_pad + 2048).astype(np.float32)).to(cuda)
    n_tiles = 6
    qidx = torch.from_numpy(rng.integers(-1, nq, (n_tiles, M)).astype(np.int32)).to(cuda)
    # an empty tile (size 0) and windows that start past position 0
    al = torch.tensor([0, 128, 1024, 2048, 2944, 3072], dtype=torch.int32, device=cuda)
    lo = torch.tensor([0, 37, 5, 0, 100, 0], dtype=torch.int32, device=cuda)
    sizes = torch.tensor([900, 600, 0, 1024, 700, 1], dtype=torch.int32, device=cuda)
    scale2 = 0.25 if dtype == torch.int8 else 1.0
    args = (x, norms, q, qidx, al, lo, sizes, scale2)
    kw = dict(W=W, m_tile=M, ip=ip, int8_mode=dtype == torch.int8, cap=cap)
    kv, ki = ivf_scan.fused_ivf_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_ivf_scan_reference(*args, **kw)
    _assert_pool(kv, ki, rv, ri, exact_ints=dtype == torch.int8)


def _pq_scan_args(case, mode, bits, book, pq_len, ip, use_pen, int8, cap, W, dev):
    M = case["qidx"].shape[1]
    cb_t = nb_ivf_scan.block_diag_codebook(torch.from_numpy(case["codebook"]), 128)
    words = torch.from_numpy(case["codes_t"].view(np.int32))
    args = (words, torch.from_numpy(case["norms"]), torch.from_numpy(case["queries"]).bfloat16(),
            cb_t, torch.from_numpy(case["centers_tile"]).bfloat16(),
            torch.from_numpy(case["qidx"]), torch.from_numpy(case["al"]),
            torch.from_numpy(case["lo"]), torch.from_numpy(case["sizes"]))
    kw = dict(W=W, m_tile=M, ip=ip, cap=cap, book=book, bits=bits, mode=mode,
              sorted_fr=torch.from_numpy(case["fr"]).to(dev) if mode == "rabitq" else None,
              use_pen=use_pen, int8_mode=int8, pq_len=pq_len)
    return tuple(a.to(dev) for a in args), kw


# a tile holds a ragged 100 slots; tile 2 is empty, tiles 1, 2 and 4 start
# their list past window position 0 (mid-slice)
_PQ_GEOM = dict(al=[0, 128, 1024, 2048, 2944, 3072], lo=[0, 37, 5, 0, 100, 0],
                sizes=[900, 600, 0, 1024, 700, 1], M=100, W=1024, n_pad=4096, nq=50)


# the deep bins' depth classes (4, 8, 16, 32) at and past each class's edge,
# and cap 1 on the two-deep bins
_DEEP_CAPS = [1, 4, 7, 8, 9, 16, 17, 32]


@pytest.mark.parametrize("ip,use_pen", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cap", [2, 3, 5] + _DEEP_CAPS)
@pytest.mark.parametrize("S,book", [(64, 256), (32, 16)])
def test_pq_scan_kernel_matches_plain_pq(cuda, ip, use_pen, int8, cap, S, book):
    case = pq_scan_case(cap + 7 * int8 + S, "pq", 8, S, book, 128 // S, use_pen=use_pen,
                        word_pad=3, **_PQ_GEOM)
    args, kw = _pq_scan_args(case, "pq", 8, book, 128 // S, ip, use_pen, int8, cap,
                             _PQ_GEOM["W"], cuda)
    kv, ki = ivf_scan.fused_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_pq_scan_reference(*args, **kw)
    _assert_pq_pool(kv, ki, rv, ri, int8)


@pytest.mark.parametrize("bits", [1, 3, 5, 8])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("cap", [2, 3, 5] + _DEEP_CAPS)
def test_pq_scan_kernel_matches_plain_rabitq(cuda, bits, ip, cap):
    case = pq_scan_case(bits + 10 * cap, "rabitq", bits, 128, 1 << bits, 1, **_PQ_GEOM)
    args, kw = _pq_scan_args(case, "rabitq", bits, 1 << bits, 1, ip, False, False, cap,
                             _PQ_GEOM["W"], cuda)
    kv, ki = ivf_scan.fused_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_pq_scan_reference(*args, **kw)
    _assert_pq_pool(kv, ki, rv, ri, False)


def _assert_pq_pool(kv, ki, rv, ri, int8):
    kv, ki, rv, ri = (t.cpu() for t in (kv, ki, rv, ri))
    assert torch.equal(torch.isfinite(kv), torch.isfinite(rv))
    assert torch.isinf(kv[2]).all()  # the empty tile holds no candidate
    fin = torch.isfinite(rv)
    close = (kv[fin] - rv[fin]).abs() <= ATOL + RTOL * rv[fin].abs()
    if int8:  # a table entry on a rounding boundary may round the other way
        assert close.float().mean() >= 0.999
        assert (ki != ri).float().mean() < 0.01
    else:  # the same sums in the same order
        assert torch.equal(kv, rv) and torch.equal(ki, ri)


def _lane_periodic(n, period):
    """Row ids r -> r % period: with period a multiple of 128, a row repeats
    every period // 128 slices in the same lane bin, so bins see exact ties."""
    return np.arange(n) % period


# the scan's operand pairs: bf16 and int8 rows on tensor cores; f32 rows
# (f32 or bf16 queries, the wrapper widens bf16) and bf16 rows with f32
# queries on the fp32 tile
_F32_TILE_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.float32)]
# caps: the cap-2 kernels (1 writes one level) and the edges of the deep
# depth classes 4, 8, 16, 32
_SCAN_CAPS = [1, 2, 3, 4, 5, 8, 9, 16, 17, 32]
_SCAN_TILE_CASES = (
    [(dt, dt, dp, ip, cap) for dt in (torch.bfloat16, torch.int8) for dp in (96, 100, 128, 256)
     for ip in (False, True) for cap in _SCAN_CAPS]
    + [(dt, qdt, dp, ip, cap) for dt, qdt in _F32_TILE_PAIRS for dp in (96, 100, 128, 256, 960)
       for ip in (False, True) for cap in _SCAN_CAPS])


# a tile of 128 slots that are all queries, one whose slots are all empty
# (zero query rows), a mixed one, one whose list fills a 256-slice window,
# one whose second 64-slot block is empty (the fp32 tile and the deep bins
# skip its products) and one with only its last slot filled; dp on and off
# the 128-byte chunk; every depth class, each over windows longer than it
@pytest.mark.parametrize("dtype,qdtype,dp,ip,cap", _SCAN_TILE_CASES)
def test_ivf_scan_mma_tiles_match_plain(cuda, dtype, qdtype, dp, ip, cap):
    rng = np.random.default_rng(dp + 7 * ip)
    M, nq, W = 128, 300, 256 * 128
    n_pad = W + 1024
    x = _data(rng, n_pad, dp, dtype, cuda)
    q = _data(rng, nq, dp, qdtype, cuda)
    norms = torch.from_numpy(rng.uniform(50, 150, n_pad).astype(np.float32)).to(cuda)
    qidx = [rng.permutation(nq)[:M], np.full(M, -1), rng.integers(-1, nq, M),
            rng.permutation(nq)[:M]]
    qidx.append(np.concatenate([rng.permutation(nq)[:M // 2], np.full(M // 2, -1)]))
    qidx.append(np.where(np.arange(M) == M - 1, 5, -1))
    qidx = np.stack(qidx).astype(np.int32)
    tiles = [torch.tensor(v, dtype=torch.int32, device=cuda)
             for v in ([0, 512, 1024, 0, 256, 128], [3, 0, 100, 0, 10, 0],
                       [1500, 900, 2000, W, 700, 1000])]
    int8 = dtype == torch.int8
    args = (x, norms, q, torch.from_numpy(qidx).to(cuda), *tiles, 0.25 if int8 else 1.0)
    kw = dict(W=W, m_tile=M, ip=ip, int8_mode=int8, cap=cap)
    kv, ki = ivf_scan.fused_ivf_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_ivf_scan_reference(*args, **kw)
    if dp > 256:
        # GIST's width: the two sum 960 products in other orders, and the
        # difference of a value near 0 grows with dp
        torch.testing.assert_close(kv.cpu(), rv.cpu(), rtol=RTOL, atol=ATOL * dp / 128)
        assert (ki != ri).float().mean() < 0.01
    else:
        _assert_pool(kv, ki, rv, ri, exact_ints=int8)


# integer-valued rows repeating every 3 slices in each lane bin: every bin
# sees exact ties, which the chain resolves as the plain version does; every
# product and sum is exact, so the pools are bit-identical
@pytest.mark.parametrize("dtype,qdtype", [(torch.bfloat16, torch.bfloat16),
                                          (torch.int8, torch.int8)] + _F32_TILE_PAIRS)
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("cap", _SCAN_CAPS)
def test_ivf_scan_ties_keep_the_reference_slice(cuda, dtype, qdtype, ip, cap):
    rng = np.random.default_rng(cap + 5 * ip)
    M, nq, W, n_pad, d = 128, 200, 2048, 4096, 100
    base = _int_valued(rng, 384, d, torch.float32, "cpu")
    x = base[_lane_periodic(n_pad, 384)].to(dtype).to(cuda).contiguous()
    q = _int_valued(rng, nq, d, qdtype, cuda)
    norms = (x.float() ** 2).sum(1)
    qidx = torch.from_numpy(rng.integers(-1, nq, (3, M)).astype(np.int32)).to(cuda)
    tiles = [torch.tensor(v, dtype=torch.int32, device=cuda)
             for v in ([0, 128, 1024], [0, 50, 7], [2048, 1700, 900])]
    args = (x, norms, q, qidx, *tiles, 1.0)
    kw = dict(W=W, m_tile=M, ip=ip, int8_mode=dtype == torch.int8, cap=cap)
    kv, ki = ivf_scan.fused_ivf_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_ivf_scan_reference(*args, **kw)
    _assert_pool(kv, ki, rv, ri, exact_ints=True)


# a window of 3 slices at caps past it: a bin takes one score a slice, so
# levels 3 and deeper hold no entry, which the deep kernels write as
# constants (depth class 4 serves cap 32 here); integer-valued rows, so the
# pools are bit-identical
@pytest.mark.parametrize("dtype,qdtype", [(torch.bfloat16, torch.bfloat16),
                                          (torch.int8, torch.int8)] + _F32_TILE_PAIRS)
@pytest.mark.parametrize("cap", [5, 32])
def test_ivf_scan_short_window_leaves_deep_levels_empty(cuda, dtype, qdtype, cap):
    rng = np.random.default_rng(cap)
    M, nq, W, n_pad, d = 100, 200, 384, 2048, 100
    x = _int_valued(rng, n_pad, d, dtype, cuda)
    q = _int_valued(rng, nq, d, qdtype, cuda)
    norms = (x.float() ** 2).sum(1)
    qidx = torch.from_numpy(rng.integers(-1, nq, (3, M)).astype(np.int32)).to(cuda)
    tiles = [torch.tensor(v, dtype=torch.int32, device=cuda)
             for v in ([0, 512, 1024], [0, 50, 7], [384, 300, 0])]
    args = (x, norms, q, qidx, *tiles, 1.0)
    kw = dict(W=W, m_tile=M, ip=False, int8_mode=dtype == torch.int8, cap=cap)
    kv, ki = ivf_scan.fused_ivf_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_ivf_scan_reference(*args, **kw)
    _assert_pool(kv, ki, rv, ri, exact_ints=True)
    assert torch.isinf(kv[:, :, 3 * 128:]).all() and not ki[:, :, 3 * 128:].any()
    assert torch.isfinite(kv[0, :, :3 * 128]).any()


def _tied_tables(case, rng, mode, use_pen=False):
    """Small-integer codebooks, queries, centers and row factors (all sums
    exact in any order) and codes repeating every 3 slices per lane bin:
    bins see exact ties, and kernel and plain version must agree bit for bit."""
    n = case["codes_t"].shape[1]
    src = _lane_periodic(n, 384)
    case["codes_t"] = np.ascontiguousarray(case["codes_t"][:, src])
    if mode == "pq":
        case["codebook"] = rng.integers(-2, 3, case["codebook"].shape).astype(np.float32)
    for key in ("queries", "centers_tile"):
        case[key] = rng.integers(-3, 4, case[key].shape).astype(np.float32)
    if not use_pen:
        case["norms"] = rng.integers(0, 16, n).astype(np.float32)[src]
    case["fr"] = rng.integers(-2, 3, n).astype(np.float32)[src]
    return case


# full 128-slot tiles, each main-path variant, with and without tied tables;
# tile 1 has only empty slots (each scores a zero query row) and tile 2 no rows
_PQ_FULL = dict(al=[0, 256, 1024, 2048], lo=[0, 5, 0, 70], sizes=[1024, 900, 0, 1800], M=128,
                W=2048, n_pad=4096, nq=300)


@pytest.mark.parametrize("mode,int8,bits,S,book", [("pq", False, 8, 64, 256),
                                                  ("pq", True, 8, 64, 256),
                                                  ("rabitq", False, 3, 128, 8)])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_pq_scan_full_tiles_match_plain(cuda, mode, int8, bits, S, book, ip, tied):
    rng = np.random.default_rng(bits + 3 * ip + 11 * tied)
    pq_len = 128 // S
    case = pq_scan_case(bits + 5 * int8, mode, bits, S, book, pq_len, **_PQ_FULL)
    case["qidx"][1] = -1
    if tied:
        case = _tied_tables(case, rng, mode)
    args, kw = _pq_scan_args(case, mode, bits, book, pq_len, ip, False, int8, 2, _PQ_FULL["W"],
                             cuda)
    kv, ki = ivf_scan.fused_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_pq_scan_reference(*args, **kw)
    if tied:
        _assert_pool(kv, ki, rv, ri, exact_ints=True)
    else:
        _assert_pq_pool(kv, ki, rv, ri, int8)


# deep bins on full 128-slot tiles and on 13-slot tiles (no slot count of a
# block divides 13: the last block holds empty slots past M), each main-path
# variant, with and without tied tables (bins see exact ties at every depth)
@pytest.mark.parametrize("mode,int8,bits,S,book", [("pq", False, 8, 64, 256),
                                                  ("pq", True, 8, 64, 256),
                                                  ("rabitq", False, 3, 128, 8)])
@pytest.mark.parametrize("M", [128, 13])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("cap", [3, 4, 7, 9, 16, 17, 32])
def test_pq_scan_deep_tiles_match_plain(cuda, mode, int8, bits, S, book, M, tied, cap):
    rng = np.random.default_rng(cap + 3 * M + 11 * tied)
    pq_len = 128 // S
    ip = cap % 2 == 1
    case = pq_scan_case(bits + 5 * int8 + cap, mode, bits, S, book, pq_len,
                        **{**_PQ_FULL, "M": M})
    case["qidx"][1] = -1
    if tied:
        case = _tied_tables(case, rng, mode)
    args, kw = _pq_scan_args(case, mode, bits, book, pq_len, ip, False, int8, cap,
                             _PQ_FULL["W"], cuda)
    kv, ki = ivf_scan.fused_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_pq_scan_reference(*args, **kw)
    if tied:
        _assert_pool(kv, ki, rv, ri, exact_ints=True)
    else:
        _assert_pq_pool(kv, ki, rv, ri, int8)


# every code width 1-9, a full book and a book one short of 2**bits (code
# 2**bits - 1 selects nothing), S on and off a whole number of 32-code
# periods; caps on the two-deep bins (1, 2) and on each depth class of the
# generic widths' deep bins (3 and 8: 8 deep; 9 and 32: 32 deep)
@pytest.mark.parametrize("bits", range(1, 10))
@pytest.mark.parametrize("short_book", [False, True])
@pytest.mark.parametrize("S", [128, 100])
@pytest.mark.parametrize("cap", [2, 3, 1, 8, 9, 32])
def test_pq_scan_rabitq_every_width(cuda, bits, short_book, S, cap):
    book = (1 << bits) - short_book
    case = pq_scan_case(bits + 20 * short_book + S, "rabitq", bits, S, 1 << bits, 1, **_PQ_GEOM)
    case["codebook"] = np.ascontiguousarray(case["codebook"][:, :book])
    args, kw = _pq_scan_args(case, "rabitq", bits, book, 1, False, False, False, cap,
                             _PQ_GEOM["W"], cuda)
    kv, ki = ivf_scan.fused_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_pq_scan_reference(*args, **kw)
    _assert_pq_pool(kv, ki, rv, ri, False)


# IVF-PQ at every width 4-8 (byte codes, book 2^b): a full book (the width's
# compile-time instantiation at caps 1-4), a full book with codes past it
# ("stray": a byte code >= book selects nothing; the period's word test
# routes it), and a book one short (the bit buffer); bf16 and int8 tables,
# S = 62 (15.5 words: off a whole period), caps on every depth class, plain
# and tied tables. Every pool bit-identical to the plain version's (int8: but
# where an entry's lut/scale sits on a rounding boundary).
@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
@pytest.mark.parametrize("book_kind", ["full", "stray", "short"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cap", [1, 2, 3, 4, 9, 32])
@pytest.mark.parametrize("tied", [False, True])
def test_pq_scan_kernel_matches_plain_pq_every_width(cuda, pq_bits, book_kind, int8, cap, tied):
    if book_kind == "stray" and pq_bits == 8:
        pytest.skip("a byte code cannot pass a book of 256")
    book = (1 << pq_bits) - (book_kind == "short")
    drawn = (1 << pq_bits) + (4 if book_kind == "stray" else 0)
    S, pq_len = 62, 2
    seed = pq_bits + 10 * cap + 7 * int8 + 100 * tied + 1000 * ["full", "stray", "short"].index(
        book_kind)
    case = pq_scan_case(seed, "pq", 8, S, drawn, pq_len, **_PQ_GEOM)
    case["codebook"] = np.ascontiguousarray(case["codebook"][:, :book])
    if tied:
        case = _tied_tables(case, np.random.default_rng(seed), "pq")
    args, kw = _pq_scan_args(case, "pq", 8, book, pq_len, cap % 2 == 1, False, int8, cap,
                             _PQ_GEOM["W"], cuda)
    kv, ki = ivf_scan.fused_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_pq_scan_reference(*args, **kw)
    if tied:
        _assert_pool(kv, ki, rv, ri, exact_ints=True)
    else:
        _assert_pq_pool(kv, ki, rv, ri, int8)


# RaBitQ at 1, 2 and 4-8 bits (a table to 4 bits, entries formed in
# registers from 5) against the plain version's table values: tied query values (small integers: every sum exact, bins see exact ties),
# near-zero ones (1e-36: products in and below the normal range) and
# subnormal ones (m * 2^-133, bf16's subnormal step, times half-integer
# levels: entries on ties of the subnormal grid, rounded to even). The row
# factors are fa = 0, fr = 1, so the pool holds the code sums themselves.
@pytest.mark.parametrize("bits", [1, 2, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("queries", ["tied", "near_zero", "subnormal"])
@pytest.mark.parametrize("cap", [2, 4])
@pytest.mark.parametrize("S", [128, 100])
def test_pq_scan_rabitq_register_entries_match_plain(cuda, bits, queries, cap, S):
    seed = bits + 10 * cap + S
    rng = np.random.default_rng(seed)
    case = pq_scan_case(seed, "rabitq", bits, S, 1 << bits, 1, **_PQ_GEOM)
    if queries == "tied":
        case = _tied_tables(case, rng, "rabitq")
    else:
        shape = case["queries"].shape
        q = (rng.standard_normal(shape) * 1e-36 if queries == "near_zero" else
             rng.integers(-127, 128, shape) * 2.0 ** -133)  # bf16's subnormals: exact
        case["queries"] = torch.from_numpy(q.astype(np.float32)).bfloat16().float().numpy()
        case["norms"] = np.zeros_like(case["norms"])
        case["fr"] = np.ones_like(case["fr"])
    args, kw = _pq_scan_args(case, "rabitq", bits, 1 << bits, 1, False, False, False, cap,
                             _PQ_GEOM["W"], cuda)
    kv, ki = ivf_scan.fused_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_pq_scan_reference(*args, **kw)
    if queries != "tied":  # the sums are tiny and not all zero
        fin = torch.isfinite(rv)
        assert (rv[fin] != 0).any() and rv[fin].abs().max() < 2.0 ** -100
    _assert_pool(kv, ki, rv, ri, exact_ints=True)


def _pq_attributes(M, dp, S, book, bits, pq_len, W, cap, rabitq, int8):
    import ctypes

    from cuvs_tpu_torch.ops import _lib

    out = (ctypes.c_int * 6)()
    _lib.check(_lib.lib().cuvs_pq_scan_attributes(M, dp, S, book, bits, pq_len, W, cap, rabitq,
                                                  int8, out), "cuvs_pq_scan_attributes")
    return dict(zip(("registers", "local_bytes", "slots", "blocks_per_sm", "depth", "family"),
                    out))


# the instantiation each width runs at the main path's shapes (pq_dim 64 x
# 2 dims; RaBitQ 128 dims): PQ 8-bit (family 1) and RaBitQ 3-bit (2) keep
# theirs; IVF-PQ's other books and RaBitQ at 1, 2 and 4 bits (3: a table)
# and RaBitQ at 5-8 bits (4: register entries) run compile-time decode at
# depth classes 2 and 4, 8 slots a block, no local memory, two blocks an SM
# but where shared memory holds one (PQ's bf16 table at 7 bits, RaBitQ at
# 8); classes 8-32 of those widths run the bit buffer (0)
@pytest.mark.parametrize("mode,width", [("pq", b) for b in range(4, 9)] +
                         [("rabitq", b) for b in range(1, 9)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cap", [1, 2, 3, 4, 9])
def test_pq_scan_widths_run_compile_time_instantiations(cuda, mode, width, int8, cap):
    if mode == "rabitq" and int8:
        pytest.skip("RaBitQ searches take no int8 table")
    rabitq = mode == "rabitq"
    S, bits, pq_len = (128, width, 1) if rabitq else (64, 8, 2)
    a = _pq_attributes(128, 128, S, 1 << width, bits, pq_len, 1024, cap, int(rabitq), int(int8))
    assert a["depth"] == (2 if cap <= 2 else 4 if cap <= 4 else 16)
    if (mode, width) in (("pq", 8), ("rabitq", 3)):
        family = 2 if rabitq else 1
    else:
        family = 0 if cap > 4 else 4 if rabitq and width >= 5 else 3
    assert a["family"] == family, a
    if family in (3, 4):
        assert a["local_bytes"] == 0 and a["slots"] == 8, a
        one = (mode, width) == ("rabitq", 8) or (mode, width, int8) == ("pq", 7, False)
        assert a["blocks_per_sm"] == (1 if one else 2), a


# 8-bit PQ codes whose count is not a multiple of the 4 threads' word shares
# (S = 60: 15 words), with tied tables, bf16 and int8
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cap", [1, 2, 4, 3, 7, 8, 9, 16, 17, 32])
def test_pq_scan_uneven_code_shares_with_ties(cuda, int8, cap):
    rng = np.random.default_rng(cap + 2 * int8)
    case = _tied_tables(pq_scan_case(cap, "pq", 8, 60, 256, 2, **_PQ_FULL), rng, "pq")
    args, kw = _pq_scan_args(case, "pq", 8, 256, 2, False, False, int8, cap, _PQ_FULL["W"], cuda)
    kv, ki = ivf_scan.fused_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_pq_scan_reference(*args, **kw)
    _assert_pool(kv, ki, rv, ri, exact_ints=True)


def test_launch_counters_count_kernel_launches(cuda):
    before = dict(bf_topk.LAUNCHES)
    q = _data(np.random.default_rng(1), 8, 32, torch.float32, cuda)
    bf_topk.fused_bf_topk(q, q, 4, exact=True)
    bf_topk.fused_bf_topk(q.cpu(), q.cpu(), 4, exact=True)  # plain version: not counted
    assert bf_topk.LAUNCHES["bf_topk_exact"] == before["bf_topk_exact"] + 1


def test_pq_scan_launch_counter_counts_kernel_launches(cuda):
    geom = dict(al=[0, 128], lo=[3, 0], sizes=[200, 0], M=8, W=256, n_pad=512, nq=4)
    case = pq_scan_case(1, "rabitq", 3, 128, 8, 1, **geom)
    before = ivf_scan.LAUNCHES["pq_scan"]
    for dev in (cuda, torch.device("cpu")):  # the CPU call runs the plain version
        args, kw = _pq_scan_args(case, "rabitq", 3, 8, 1, False, False, False, 2, 256, dev)
        ivf_scan.fused_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES["pq_scan"] == before + 1


def test_scan_wrappers_reject_operands_off_the_card(cuda):
    """A host tensor beside CUDA codes or rows raises instead of reaching the
    kernel as a host pointer."""
    geom = dict(al=[0, 128], lo=[3, 0], sizes=[200, 0], M=8, W=256, n_pad=512, nq=4)
    case = pq_scan_case(2, "pq", 8, 64, 256, 2, **geom)
    args, kw = _pq_scan_args(case, "pq", 8, 256, 2, False, False, False, 2, 256, cuda)
    for i in (2, 3, 4):  # queries_rot, cb_t, centers_tile
        with pytest.raises(ValueError):
            ivf_scan.fused_pq_scan(*args[:i], args[i].cpu(), *args[i + 1:], **kw)
    rng = np.random.default_rng(3)
    x = _data(rng, 512, 32, torch.float32, cuda)
    norms = (x * x).sum(1)
    tiles = [torch.tensor(v, dtype=torch.int32, device=cuda) for v in ([0], [0], [200])]
    qidx = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ivf_scan.fused_ivf_scan(x, norms, x[:4].cpu(), qidx, *tiles, 1.0, W=256, m_tile=8,
                                ip=False, int8_mode=False)
    torch.cuda.synchronize()  # the context is still healthy


def test_ivf_build_is_reproducible(cuda):
    from cuvs_tpu_torch.neighbors import ivf_flat

    x = _data(np.random.default_rng(5), 60000, 32, torch.float32, cuda)
    a = ivf_flat.build(x, n_lists=64, seed=0)
    b = ivf_flat.build(x, n_lists=64, seed=0)
    assert torch.equal(a.centers, b.centers)
    assert torch.equal(a.lists.ids, b.lists.ids)


def _moved(index, dev):
    """A copy of an index dataclass with every tensor on ``dev``."""
    import dataclasses

    from cuvs_tpu_torch.neighbors.ivf_common import SortedLists

    kw = {}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
        elif isinstance(v, SortedLists):
            v = SortedLists(*(t.to(dev) for t in v))
        elif isinstance(v, tuple):  # the packed CAGRA's child_vecs pieces
            v = tuple(t.to(dev) for t in v)
        kw[f.name] = v
    return type(index)(**kw)


def _blobs(seed, n, d):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)) * 5.0
    return (centers[rng.integers(0, 40, n)] + rng.standard_normal((n, d))).astype(np.float32)


def test_streamed_int8_index_scan_kernel_matches_plain(cuda, monkeypatch):
    """An int8 index built by build_streaming (host mode) at d = 96, its rows
    padded to 128: the ivf_scan kernel's pool is bit-identical to the plain
    version's on the inputs the search gives it."""
    from cuvs_tpu_torch.neighbors import ivf_flat

    x = _blobs(6, 24000, 96)
    idx = ivf_flat.build_streaming(lambda i: x[i * 6000:(i + 1) * 6000], 4, n_lists=64,
                                   trainset_rows=8000, device=cuda)
    assert idx.sorted_data.dtype == torch.int8 and idx.sorted_data.shape[1] == 128
    calls = []
    real = ivf_scan.fused_ivf_scan
    monkeypatch.setattr(ivf_scan, "fused_ivf_scan",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    q = torch.from_numpy(x[:300] + 0.1).to(cuda)
    ivf_flat.search(idx, q, 10, n_probes=16, scan_algo="fused")
    (args, kw), = calls
    kv, ki = real(*args, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.fused_ivf_scan_reference(*args, **kw)
    _assert_pool(kv, ki, rv, ri, exact_ints=True)


@pytest.mark.parametrize("case", ["l2", "cosine", "int8", "pq_per_subspace", "pq_per_cluster",
                                  "sq"])
def test_unfused_scans_on_the_card_match_the_cpu(cuda, case):
    """cluster_major_scan_tiled (IVF-Flat), cluster_major_scan_pq (IVF-PQ,
    bins) and the IVF-SQ scan: the same call on CUDA and CPU tensors."""
    from cuvs_tpu_torch.neighbors import ivf_flat, ivf_pq, ivf_sq

    x, q = _blobs(7, 8000, 40), torch.from_numpy(_blobs(8, 200, 40))
    xt = torch.from_numpy(x)
    kw = dict(n_probes=8, scan_algo="cluster_major")
    if case.startswith("pq"):
        mod = ivf_pq
        idx = ivf_pq.build(xt, n_lists=32, pq_dim=10, pq_bits=6, seed=0,
                           codebook_gen=case[3:], max_train_points_per_pq_code=32)
    elif case == "sq":
        mod, kw = ivf_sq, dict(n_probes=8)
        idx = ivf_sq.build(xt, n_lists=32, seed=0)
    else:
        mod = ivf_flat
        idx = ivf_flat.build(xt, n_lists=32, seed=0, metric="cosine" if case == "cosine" else "l2",
                             storage_dtype=torch.int8 if case == "int8" else None)
    cd, ci = mod.search(idx, q, 10, **kw)
    gd, gi = mod.search(_moved(idx, cuda), q.to(cuda), 10, **kw)
    torch.testing.assert_close(gd.cpu(), cd, rtol=RTOL, atol=ATOL)
    ids_match_modulo_ties(gi.cpu().numpy(), ci.numpy(), cd.numpy(), RTOL, ATOL)


def test_device_mode_build_streaming_matches_host_mode(cuda):
    """Device mode labels the f32 rows, host mode their bf16 roundings: the
    same centers, the same int8 row for every id, labels equal but for rows
    near a boundary, norms f32 sums in another order."""
    from cuvs_tpu_torch.neighbors import ivf_flat

    x = _blobs(9, 40000, 96)
    kw = dict(n_lists=64, trainset_rows=10000, device=cuda)
    h = ivf_flat.build_streaming(lambda i: x[i * 10000:(i + 1) * 10000], 4, **kw)
    d = ivf_flat.build_streaming(
        lambda i: torch.from_numpy(x[i * 10000:(i + 1) * 10000]).to(cuda), 4, **kw)
    assert torch.equal(h.centers, d.centers) and torch.equal(h.q_scale, d.q_scale)
    n = h.n_rows
    oh, od = (torch.argsort(ix.lists.ids[:n].long()) for ix in (h, d))
    assert torch.equal(h.sorted_data[:n][oh], d.sorted_data[:n][od])
    torch.testing.assert_close(h.sorted_norms[:n][oh], d.sorted_norms[:n][od], rtol=1e-6, atol=0)
    assert (h.lists.labels[:n][oh] != d.lists.labels[:n][od]).float().mean() < 0.01


def test_serialize_round_trip_on_the_card(cuda, tmp_path):
    from cuvs_tpu_torch.neighbors import ivf_flat, ivf_pq
    from cuvs_tpu_torch.utils import serialize

    x = torch.from_numpy(_blobs(10, 20000, 64)).to(cuda)
    q = x[:256] + 0.05
    for index, search in (
            (ivf_pq.build(x, n_lists=32, pq_dim=32, seed=0),
             lambda ix: ivf_pq.search(ix, q, 10, n_probes=8, scan_algo="fused")),
            (ivf_flat.build(x, n_lists=32, seed=0, storage_dtype=torch.bfloat16),
             lambda ix: ivf_flat.search(ix, q, 10, n_probes=8, scan_algo="fused"))):
        path = str(tmp_path / "index.npz")
        serialize.save(path, index)
        loaded = serialize.load(path)
        assert loaded.centers.is_cuda
        (a, b), (c, e) = search(index), search(loaded)
        assert torch.equal(a, c) and torch.equal(b, e)


def _cloud(seed, n, d):
    return (np.random.default_rng(seed).standard_normal((n, d)) * 2).astype(np.float32)


def test_graph_optimize_on_the_card_equals_the_cpu(cuda):
    """Detour counts (at the card's own chunk size and a small one), the
    prune, the reverse graph and the merge are exact integer work."""
    from cuvs_tpu_torch.neighbors import graph_core, knn_graph

    x = torch.from_numpy(_cloud(11, 6000, 32))
    knn, _ = knn_graph.build_knn_graph(x, 48, algo="brute_force")
    kc = knn.to(cuda)
    for chunk in (0, 100):
        assert torch.equal(graph_core._detour_counts(kc, chunk=chunk).cpu(),
                           graph_core._detour_counts(knn, chunk=chunk))
    assert torch.equal(graph_core.optimize(kc, 24).cpu(), graph_core.optimize(knn, 24))
    g = graph_core.optimize(knn, 24)
    assert torch.equal(graph_core.connected_components(g.to(cuda)).cpu(),
                       graph_core.connected_components(g))


def test_graph_functions_put_host_graphs_on_the_card(cuda):
    """A numpy graph (and dataset) with no device named goes to the card, as
    every entry point's host data does."""
    from cuvs_tpu_torch.neighbors import graph_core, knn_graph

    x = _cloud(17, 3000, 16)
    x[1000:2000] += 40.0  # three blobs: the knn graph has three components
    x[2000:] -= 40.0
    knn = knn_graph.build_knn_graph(x, 16, algo="brute_force", device="cpu")[0].numpy()
    lab = graph_core.connected_components(knn)
    assert lab.is_cuda and torch.equal(lab.cpu(), graph_core.connected_components(
        torch.from_numpy(knn)))
    assert len(torch.unique(lab)) == 3
    aug = graph_core.augment_connectivity(knn, dataset=x)
    assert aug.is_cuda and torch.equal(aug.cpu(), graph_core.augment_connectivity(
        torch.from_numpy(knn), dataset=torch.from_numpy(x)))
    assert len(torch.unique(graph_core.connected_components(aug))) == 1


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_cagra_search_on_the_card_matches_the_cpu(cuda, compute):
    """The same index and the same seeds (drawn on the host): the card's ids
    equal the CPU's but for near-ties that steer a beam elsewhere (<= 1%),
    and their distances agree where the ids do."""
    from cuvs_tpu_torch.neighbors import cagra

    x, q = _cloud(12, 8000, 32), _cloud(13, 300, 32)
    host = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0, device="cpu")
    card = cagra.Index(dataset=host.dataset.to(cuda), dataset_norms=host.dataset_norms.to(cuda),
                       graph=host.graph.to(cuda), metric=host.metric)
    for width, ring in ((1, 0), (2, -1)):
        kw = dict(itopk_size=64, search_width=width, visited_size=ring, compute_dtype=compute,
                  query_chunk=128, seed=7)
        hd, hi = cagra.search(host, torch.from_numpy(q), 10, **kw)
        cd, ci = cagra.search(card, torch.from_numpy(q).to(cuda), 10, **kw)
        same = ci.cpu() == hi
        assert float(same.float().mean()) >= 0.99
        torch.testing.assert_close(cd.cpu()[same], hd[same], rtol=RTOL, atol=ATOL)


def test_cagra_build_on_the_card_is_valid(cuda):
    from cuvs_tpu_torch.neighbors import cagra

    x = torch.from_numpy(_cloud(14, 20000, 32)).to(cuda)
    for algo in ("brute_force", "partitioned", "ivf_pq"):
        g = cagra.build(x, intermediate_graph_degree=48, graph_degree=24, build_algo=algo,
                        seed=0).graph
        assert g.is_cuda and g.shape == (20000, 24)
        assert bool(((g >= 0) & (g < 20000)).all())
        s = torch.sort(g, 1).values
        assert not bool((s[:, 1:] == s[:, :-1]).any())


_METRICS = ["sqeuclidean", "euclidean", "cosine", "inner_product", "correlation", "l1",
            "chebyshev", "canberra", "minkowski", "braycurtis", "L2Unexpanded",
            "L2SqrtUnexpanded", "hellinger", "jensenshannon", "kl_divergence", "hamming",
            "jaccard", "dice", "russellrao", "haversine", "bitwise_hamming"]


@pytest.mark.parametrize("metric", _METRICS)
def test_pairwise_distance_on_the_card_matches_the_cpu(cuda, metric):
    from cuvs_tpu_torch.distance import pairwise

    rng = np.random.default_rng(len(metric))
    if metric == "bitwise_hamming":
        a, b = (rng.integers(0, 256, (200, 64)).astype(np.uint8) for _ in "ab")
    elif metric == "haversine":
        a, b = (((rng.random((200, 2)) - 0.5) * [np.pi, 2 * np.pi]).astype(np.float32)
                for _ in "ab")
    elif metric in ("hellinger", "jensenshannon", "kl_divergence"):
        a, b = (rng.random((200, 96)).astype(np.float32) + 0.01 for _ in "ab")
        a, b = a / a.sum(1, keepdims=True), b / b.sum(1, keepdims=True)
    elif metric in ("hamming", "jaccard", "dice", "russellrao"):
        a, b = ((rng.random((200, 96)) > 0.5).astype(np.float32) for _ in "ab")
    else:
        a, b = (rng.standard_normal((200, 96)).astype(np.float32) for _ in "ab")
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    host = pairwise.pairwise_distance(a, b, metric=metric, p=3.0)
    card = pairwise.pairwise_distance(a.to(cuda), b.to(cuda), metric=metric, p=3.0)
    assert card.is_cuda and card.dtype == torch.float32
    torch.testing.assert_close(card.cpu(), host, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l1", "chebyshev", "minkowski"])
def test_long_tail_brute_force_on_the_card_matches_the_cpu(cuda, metric):
    from cuvs_tpu_torch.neighbors import brute_force
    from torch_parity import ids_match_modulo_ties

    x, q = torch.from_numpy(_cloud(15, 30000, 32)), torch.from_numpy(_cloud(16, 64, 32))
    hd, hi = brute_force.search(brute_force.build(x, metric=metric, metric_arg=3.0), q, 10,
                                tile_size=7000)
    cd, ci = brute_force.search(brute_force.build(x.to(cuda), metric=metric, metric_arg=3.0),
                                q.to(cuda), 10, tile_size=7000)
    torch.testing.assert_close(cd.cpu(), hd, rtol=RTOL, atol=ATOL)
    ids_match_modulo_ties(ci.cpu().numpy(), hi.numpy(), hd.numpy(), RTOL, ATOL)


@pytest.fixture(scope="module")
def cagra_host():
    from cuvs_tpu_torch.neighbors import cagra

    x, q = _cloud(21, 8000, 32), _cloud(22, 300, 32)
    return x, q, cagra.build(x, intermediate_graph_degree=48, graph_degree=24, seed=0,
                             device="cpu")


def test_pack_codes_on_the_card_equal_the_cpu(cuda, cagra_host):
    """The int8 codes divide by a tensor scale on both devices: bit-identical
    codes, scale, pieces (three, one padded tail) and child norms."""
    from cuvs_tpu_torch.neighbors import cagra

    _, _, host = cagra_host
    for kw in (dict(), dict(_blk=3000, _piece_bytes=8000 * 32 * 8)):
        h, c = cagra.pack(host, **kw), cagra.pack(_moved(host, cuda), **kw)
        assert c.dataset_int8.is_cuda and torch.equal(c.dataset_int8.cpu(), h.dataset_int8)
        assert torch.equal(c.scale.cpu(), h.scale)
        assert torch.equal(c.child_norms.cpu(), h.child_norms)
        assert len(c.child_vecs) == len(h.child_vecs)
        for a, b in zip(c.child_vecs, h.child_vecs):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("layout", ["packed", "compressed"])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_cagra_layouts_search_on_the_card_matches_the_cpu(cuda, cagra_host, layout, compute):
    """The same packed or VPQ index and the same host-drawn seeds: the card's
    ids equal the CPU's but for near-ties (<= 1%), distances where ids agree."""
    from cuvs_tpu_torch.neighbors import cagra

    _, q, host = cagra_host
    ix = cagra.pack(host) if layout == "packed" else cagra.compress(host, vq_n_centers=64,
                                                                   pq_dim=8)
    card = _moved(ix, cuda)
    kw = dict(itopk_size=64, search_width=2, compute_dtype=compute, query_chunk=128, seed=7)
    hd, hi = cagra.search(ix, torch.from_numpy(q), 10, **kw)
    cd, ci = cagra.search(card, torch.from_numpy(q).to(cuda), 10, **kw)
    same = ci.cpu() == hi
    assert float(same.float().mean()) >= 0.99
    torch.testing.assert_close(cd.cpu()[same], hd[same], rtol=RTOL, atol=ATOL)


def test_robust_prune_on_the_card_equals_the_cpu(cuda):
    from cuvs_tpu_torch.neighbors import vamana

    rng = np.random.default_rng(23)
    B, C, d, R = 500, 64, 32, 24
    vecs = torch.from_numpy(rng.standard_normal((B, C, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 100000, (B, C)).astype(np.int32))
    dist = torch.from_numpy(np.sort(rng.uniform(1.0, 50.0, (B, C)).astype(np.float32), 1))
    dist[:, -6:] = float("inf")
    pts = torch.zeros((B, d))
    host = vamana._robust_prune(ids, dist, pts, vecs, 1.2, R)
    card = vamana._robust_prune(ids.to(cuda), dist.to(cuda), pts.to(cuda), vecs.to(cuda), 1.2, R)
    assert card.is_cuda and torch.equal(card.cpu(), host)


def test_scann_chunks_on_the_card_match_one_chunk(cuda):
    """The AVQ systems summed over row chunks, and SOAR scored in row chunks,
    against one chunk holding every row (the reference's unchunked form)."""
    from cuvs_tpu_torch.cluster import kmeans_balanced
    from cuvs_tpu_torch.neighbors import scann

    x = torch.from_numpy(_blobs(24, 50000, 64)).to(cuda)
    centers = kmeans_balanced.fit(x, 64, seed=0)
    labels = kmeans_balanced.predict(x, centers)
    whole = scann._avq_refine(x, centers, labels, 2.0, chunk=50000)
    for chunk in (0, 777):
        torch.testing.assert_close(scann._avq_refine(x, centers, labels, 2.0, chunk=chunk), whole,
                                   rtol=1e-4, atol=1e-5)
    one = scann._soar_assign(x, whole, labels, 1.5, chunk=50000)
    assert torch.equal(scann._soar_assign(x, whole, labels, 1.5, chunk=777), one)
    host = scann._soar_assign(x.cpu(), whole.cpu(), labels.cpu(), 1.5)
    assert float((host == one.cpu()).float().mean()) >= 0.999


def test_section_zero_entry_points_put_numpy_on_the_card(cuda):
    """select_k, merge_parts, the bitset constructors, the prefilter from a
    mask and bitpack: numpy in, a CUDA tensor out."""
    from cuvs_tpu_torch.core import bitpack, bitset
    from cuvs_tpu_torch.neighbors import filters
    from cuvs_tpu_torch.selection import select_k

    rng = np.random.default_rng(25)
    v = rng.standard_normal((8, 40)).astype(np.float32)
    ids = rng.integers(0, 1000, (8, 40)).astype(np.int32)
    mask = v > 0
    outs = [select_k.select_k(v, 5)[0], select_k.merge_parts([v[:, :20], v[:, 20:]],
                                                             [ids[:, :20], ids[:, 20:]], 5)[1],
            bitset.bitset_create(100), bitset.bitset_from_mask(mask[0]),
            bitset.bitmap_from_mask(mask), filters.from_mask(mask).bits,
            bitpack.pack(mask.astype(np.int64), 1),
            bitpack.unpack(rng.integers(0, 1 << 32, (8, 2), dtype=np.uint32), 4, 16)]
    assert all(t.is_cuda for t in outs)
    host = bitpack.pack(mask.astype(np.int64), 1, device="cpu")
    assert torch.equal(outs[6].cpu(), host)


def _mg_on(index, devices):
    from cuvs_tpu_torch.mg import snmg
    from cuvs_tpu_torch.utils.device import index_to

    return snmg.MGIndex(shards=[index_to(s, d) for s, d in zip(index.shards, devices)],
                        row_offsets=index.row_offsets, algo=index.algo, mode=index.mode,
                        n_rows=index.n_rows)


@pytest.mark.parametrize("algo", ["brute_force", "ivf_flat", "ivf_pq"])
def test_mg_on_a_repeated_card_equals_mg_on_the_cpu(cuda, algo):
    """Four shards on [cuda] * 4 (a repeated device) against the same shards
    on the CPU: exact searches agree to rtol 1e-5 with ids equal but at ties;
    the IVF searches run the fused kernels on the card and their plain
    versions on the CPU, so >= 99% of (query, rank) ids agree."""
    from cuvs_tpu_torch import mg

    x, q = _blobs(41, 20001, 64), _blobs(42, 300, 64)
    kw = {"ivf_flat": dict(n_lists=32, seed=0), "ivf_pq": dict(n_lists=32, pq_dim=32, seed=0)}
    host = mg.build(x, algo, devices=["cpu"] * 4, **kw.get(algo, {}))
    card = _mg_on(host, [cuda] * 4)
    assert all(s.device.type == "cuda" for s in card.shards)
    skw = {} if algo == "brute_force" else dict(n_probes=8, scan_algo="fused")
    hd, hi = mg.search(host, torch.from_numpy(q), 10, **skw)
    cd, ci = mg.search(card, q, 10, **skw)
    assert ci.is_cuda
    if algo == "brute_force":
        torch.testing.assert_close(cd.cpu(), hd, rtol=RTOL, atol=ATOL)
        ids_match_modulo_ties(ci.cpu().numpy(), hi.numpy(), hd.numpy())
    else:
        assert float((ci.cpu() == hi).float().mean()) >= 0.99


def test_mg_build_and_kmeans_on_a_repeated_card(cuda):
    from cuvs_tpu_torch import mg
    from cuvs_tpu_torch.cluster import kmeans

    x = torch.from_numpy(_blobs(43, 20000, 32)).to(cuda)
    idx = mg.build(x, "ivf_flat", devices=[cuda] * 4, n_lists=16, seed=0)
    assert [s.n_rows for s in idx.shards] == [5000] * 4
    assert all(s.sorted_data.is_cuda for s in idx.shards)
    init = x[:16]
    c_mg, _ = mg.kmeans_fit(x, 16, devices=[cuda] * 4, max_iter=10, init_centers=init)
    c_sg, _, _, _ = kmeans.fit(x, n_clusters=16, init_centers=init, max_iter=10)
    torch.testing.assert_close(c_mg, c_sg, rtol=1e-4, atol=1e-4)
    c_pp, inertia = mg.kmeans_fit(x, 16, devices=[cuda] * 4, max_iter=5, seed=0)
    assert c_pp.is_cuda and bool(torch.isfinite(inertia))


def test_offload_shards_sit_in_pinned_memory(cuda):
    from cuvs_tpu_torch.neighbors import brute_force, offload

    x, q = _blobs(44, 8000, 32), _blobs(45, 64, 32)
    idx = offload.build(x, "brute_force", n_shards=3)
    assert all(s.dataset.device.type == "cpu" and s.dataset.is_pinned() for s in idx.shards)
    d, i = offload.search(idx, q, 10)
    bd, bi = brute_force.search(brute_force.build(x), q, 10)
    np.testing.assert_allclose(d, bd.cpu().numpy(), rtol=RTOL, atol=ATOL)
    ids_match_modulo_ties(i, bi.cpu().numpy(), d)


def test_tiered_index_runs_on_the_card(cuda):
    from cuvs_tpu_torch.neighbors import brute_force, ivf_flat, tiered_index
    from cuvs_tpu_torch.ops import bf_topk

    x, q = _blobs(46, 12000, 32), _blobs(47, 64, 32)
    t = tiered_index.build(ivf_flat, x[:10000], ann_params=ivf_flat.IndexParams(n_lists=16),
                           min_ann_rows=5000)
    t = tiered_index.extend(t, x[10000:])
    assert t.bf_data.is_cuda and t.ann_index.centers.is_cuda
    before = bf_topk.LAUNCHES["bf_topk_exact"]
    d, i = tiered_index.search(t, q, 10, n_probes=16)
    assert bf_topk.LAUNCHES["bf_topk_exact"] > before  # the hot tier ran the exact kernel
    bd, bi = brute_force.search(brute_force.build(x), q, 10)
    assert float((i == bi).float().mean()) >= 0.99


def test_host_library_builds_here(tmp_path):
    from cuvs_tpu_torch import io as cio
    from cuvs_tpu_torch.io import native

    assert cio.native_available() and native.library_path().exists()
    x = _blobs(48, 1000, 17)
    cio.write_bin(str(tmp_path / "x.fbin"), x)
    np.testing.assert_array_equal(cio.load_bin(str(tmp_path / "x.fbin")), x)


def test_ball_cover_on_the_card_matches_the_cpu(cuda):
    from cuvs_tpu_torch.neighbors import ball_cover
    from cuvs_tpu_torch.utils.device import index_to

    x, q = _blobs(50, 6000, 16), _blobs(51, 64, 16)
    idx = ball_cover.build(x, seed=0)
    assert idx.radii.is_cuda and idx.inner.sorted_data.is_cuda
    host = ball_cover.Index(inner=index_to(idx.inner, "cpu"), radii=idx.radii.cpu())
    for two_pass in (True, False):
        d, i = ball_cover.knn_query(idx, q, 10, two_pass=two_pass)
        hd, hi = ball_cover.knn_query(host, torch.from_numpy(q), 10, two_pass=two_pass)
        np.testing.assert_allclose(d.cpu().numpy(), hd.numpy(), rtol=RTOL, atol=ATOL)
        ids_match_modulo_ties(i.cpu().numpy(), hi.numpy(), hd.numpy())
    adj, deg = ball_cover.eps_nn(idx, x[:32], 3.0)
    hadj, hdeg = ball_cover.eps_nn(host, torch.from_numpy(x[:32]), 3.0)
    dist = np.sqrt(((x[:32, None].astype(np.float64) - x[None]) ** 2).sum(-1))
    assert bool(((adj.cpu() == hadj).numpy() | (np.abs(dist - 3.0) <= 1e-5 * 3.0)).all())


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine", "hellinger",
                                    "l1", "linf", "braycurtis", "jensenshannon"])
def test_sparse_brute_force_on_the_card_matches_the_cpu(cuda, metric):
    import scipy.sparse as sp

    from cuvs_tpu_torch.neighbors import sparse_brute_force as sbf

    rs = np.random.RandomState(52)
    x = sp.random(900, 400, density=0.05, random_state=rs, format="csr", dtype=np.float32)
    q = sp.random(40, 400, density=0.05, random_state=rs, format="csr", dtype=np.float32)
    blocks = dict(query_block=16, index_block=256, feature_tile=128)
    d, i = sbf.search(sbf.from_scipy(x, metric=metric), q.indptr, q.indices, q.data, 7, **blocks)
    assert d.is_cuda and i.dtype == torch.int64
    hd, hi = sbf.search(sbf.from_scipy(x, metric=metric, device="cpu"), q.indptr, q.indices,
                        q.data, 7, **blocks)
    np.testing.assert_allclose(d.cpu().numpy(), hd.numpy(), rtol=RTOL, atol=ATOL)
    order = -hd.numpy() if metric == "inner_product" else hd.numpy()
    ids_match_modulo_ties(i.cpu().numpy(), hi.numpy(), order)


def test_boruvka_mask_on_the_card_equals_the_cpu(cuda):
    from cuvs_tpu_torch.cluster import agglomerative

    rng = np.random.default_rng(53)
    n, m = 5000, 40000
    u = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
    v = torch.from_numpy(((u.numpy() + rng.integers(1, n, m)) % n).astype(np.int32))
    w = torch.from_numpy(rng.integers(1, 20, m).astype(np.float32))  # repeated weights
    host = agglomerative._boruvka_forest(u, v, w, n)
    card = agglomerative._boruvka_forest(u.to(cuda), v.to(cuda), w.to(cuda), n)
    assert card.is_cuda and torch.equal(card.cpu(), host)


def test_capi_bridge_on_the_card_equals_a_direct_call(cuda, monkeypatch):
    from cuvs_tpu_torch import capi_bridge
    from cuvs_tpu_torch.neighbors import brute_force

    monkeypatch.setattr(capi_bridge, "_DEVICE", None)
    capi_bridge.init("gpu")
    x, q = _blobs(54, 5000, 32), _blobs(55, 64, 32)
    handle = capi_bridge.build("brute_force", "sqeuclidean", "{}", x.ctypes.data, 5000, 32)
    assert handle[1].dataset.is_cuda
    out_d = np.zeros((64, 10), np.float32)
    out_i = np.zeros((64, 10), np.int32)
    capi_bridge.search(handle, '{"fused": true}', q.ctypes.data, 64, 32, 10, out_d.ctypes.data,
                       out_i.ctypes.data)
    assert capi_bridge.sync()
    d, i = brute_force.search(brute_force.build(x), q, 10, fused=True)
    np.testing.assert_array_equal(out_i, i.cpu().numpy())
    np.testing.assert_array_equal(out_d, d.cpu().numpy())


def test_bench_cli_on_the_card_searches_through_the_kernels(cuda, tmp_path, capsys):
    import json

    from cuvs_tpu_torch.bench import __main__ as cli

    before = {**bf_topk.LAUNCHES, **ivf_scan.LAUNCHES}
    common = ["--dataset", "synthetic-100k-96", "--max-rows", "20000", "--reps", "1",
              "--cache-dir", str(tmp_path)]
    rows = cli.main(common + ["--algo", "brute_force", "--search-grid",
                              '{"fused": [true], "recall_target": [null, 0.97]}'])
    rows += cli.main(common + ["--algo", "ivf_flat", "--build-params", '{"n_lists": 64}',
                               "--search-grid", '{"n_probes": [8, 32]}'])
    rows += cli.main(common + ["--config", "ivf_pq", "--group", "tiny"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == [r.as_dict() for r in rows]
    assert len(rows) == 2 + 2 + 8
    assert rows[0].recall >= 0.999 and rows[1].recall >= 0.9  # exact; f32 approx
    assert rows[3].recall >= rows[2].recall - 0.005
    after = {**bf_topk.LAUNCHES, **ivf_scan.LAUNCHES}
    assert all(after[name] > before[name] for name in after), (before, after)


def test_profiler_trace_names_a_port_kernel(cuda, tmp_path):
    import json

    from cuvs_tpu_torch.neighbors import brute_force
    from cuvs_tpu_torch.utils import tracing

    x, q = _blobs(60, 20000, 64), _blobs(61, 256, 64)
    index = brute_force.build(torch.from_numpy(x).to(cuda))
    brute_force.search(index, torch.from_numpy(q).to(cuda), 10, fused=True)  # warm-up
    torch.cuda.synchronize()
    tracing.start_profiler_trace(str(tmp_path))
    brute_force.search(index, torch.from_numpy(q).to(cuda), 10, fused=True)
    torch.cuda.synchronize()
    path = tracing.stop_profiler_trace()
    with open(path) as f:
        kernels = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    assert any("bf_topk_exact" in name for name in kernels), sorted(kernels)


def test_hnsw_cpu_builds_from_the_port_host_library():
    from cuvs_tpu_torch.bench.competitors import HnswCpu
    from cuvs_tpu_torch.io import native

    x, q = _blobs(62, 4000, 32), _blobs(63, 50, 32)
    d, i = HnswCpu(M=16, ef_construction=100).build(x).search(q, 10, ef=128)
    assert native.library_path().exists()
    exact = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i.tolist(), exact.tolist())])
    assert recall >= 0.9, recall
