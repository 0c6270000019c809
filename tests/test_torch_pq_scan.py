"""Fused quantized-code scan (kernel 4), its serving layout and bit packing:
the port against the JAX package on the CPU, the reference's Pallas kernel in
interpret mode.

Tolerances: bit packing, the transposed code layout and the block-diagonal
codebook are integer or copy work and must be identical; decoded norms sum
the same f32 terms in the same order and must be identical. Scan pools: the
lookup-table entries are f32 sums of exact bf16 products; with a bf16 table
the scores are f32 sums of bf16 terms in another order, compared at rtol 1e-5
/ atol 1e-4 with ids equal except at ties. With an int8 table both sides
quantize identical entries with one scale per tile, so values agree at the
same tolerance except where an entry's lut/scale sits on a rounding
boundary: at most 0.1% of the pool entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.core import bitpack as jax_bitpack
from cuvs_tpu.neighbors import ivf_scan as jax_ivf_scan
from cuvs_tpu.ops import ivf_scan_pallas
from cuvs_tpu_torch.core import bitpack
from cuvs_tpu_torch.interop import _tensor
from cuvs_tpu_torch.neighbors import ivf_scan
from cuvs_tpu_torch.ops import ivf_scan as ops_ivf_scan
from tests.torch_parity import pq_scan_case

torch.set_num_threads(1)


@pytest.mark.parametrize("bits", range(1, 10))
def test_bitpack_matches_reference(bits):
    rng = np.random.default_rng(bits)
    S = 37  # 37 * bits is no multiple of 32: the last word is partial
    codes = rng.integers(0, 1 << bits, (5, 3, S))
    ref = np.asarray(jax_bitpack.pack(jnp.asarray(codes), bits))
    got = bitpack.pack(torch.from_numpy(codes), bits)
    assert got.dtype == torch.int32 and got.shape[-1] == bitpack.packed_words(S, bits)
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    straddles = any((s * bits) % 32 + bits > 32 for s in range(S))
    assert straddles == (bits not in (1, 2, 4, 8))
    # unpack takes the port's int32 words and the reference's uint32 words
    assert np.array_equal(bitpack.unpack(got, bits, S).numpy(), codes)
    assert np.array_equal(bitpack.unpack(ref, bits, S, device="cpu").numpy(),
                          np.asarray(jax_bitpack.unpack(jnp.asarray(ref), bits, S)))
    assert bitpack.packed_bytes(S, bits) == jax_bitpack.packed_bytes(S, bits)


def test_serving_layout_matches_reference_without_its_pads():
    rng = np.random.default_rng(2)
    n, S, book, pq_len, window = 300, 12, 16, 3, 128  # S/4 = 3 word rows (the reference pads 8)
    codes = rng.integers(0, book, (n, S)).astype(np.uint8)
    cbk = rng.standard_normal((S, book, pq_len)).astype(np.float32)
    dp = 128

    ref_cb = np.asarray(jax_ivf_scan.block_diag_codebook(jnp.asarray(cbk), dp, jnp.bfloat16))
    got_cb = ivf_scan.block_diag_codebook(torch.from_numpy(cbk), dp)
    assert got_cb.dtype == torch.bfloat16 and got_cb.is_contiguous()
    assert torch.equal(got_cb, _tensor(ref_cb, "cpu"))

    ref_t = np.asarray(jax_ivf_scan.pack_codes_transposed(jnp.asarray(codes), window))
    got_t = ivf_scan.pack_codes_transposed(torch.from_numpy(codes), window)
    assert got_t.shape == (3, n + window) and ref_t.shape == (8, n + window)
    assert np.array_equal(got_t.numpy().view(np.uint32), ref_t[:3])
    assert not ref_t[3:].any()

    ref_n = np.asarray(jax_ivf_scan.decoded_norms(jnp.asarray(codes), jnp.asarray(cbk), window,
                                                  window + 128))
    got_n = ivf_scan.decoded_norms(torch.from_numpy(codes), torch.from_numpy(cbk), window,
                                   window + 128)
    assert got_n.shape == (n + window,) and ref_n.shape[0] > n + window
    assert np.array_equal(got_n.numpy(), ref_n[:n + window])
    assert not ref_n[n + window:].any()


# 4 tiles of 8 slots over a 256-row window: tile 2 is empty, tiles 0 and 2
# start their list past window position 0, qidx holds empty slots (-1)
_GEOM = dict(al=[0, 128, 256, 512], lo=[5, 0, 100, 0], sizes=[200, 250, 0, 140], M=8, W=256,
             n_pad=1024)


def _both_scans(case, mode, bits, book, pq_len, ip, use_pen, int8, cap):
    W = _GEOM["W"]
    rabitq = mode == "rabitq"
    jcb = jax_ivf_scan.block_diag_codebook(jnp.asarray(case["codebook"]), 128, jnp.bfloat16)
    jv, ji = ivf_scan_pallas.fused_pq_scan(
        jnp.asarray(case["codes_t"]), jnp.asarray(case["norms"]),
        jnp.asarray(case["queries"]).astype(jnp.bfloat16), jcb,
        jnp.asarray(case["centers_tile"]).astype(jnp.bfloat16), jnp.asarray(case["qidx"]),
        case["al"], case["lo"], case["sizes"], W=W, m_tile=_GEOM["M"], inner=128, ip=ip,
        cap=cap, book=book, bits=bits, mode=mode,
        sorted_fr=jnp.asarray(case["fr"]) if rabitq else None, use_pen=use_pen,
        int8_mode=int8, interpret=True)
    tv, ti = ops_ivf_scan.fused_pq_scan(
        torch.from_numpy(case["codes_t"].view(np.int32)), torch.from_numpy(case["norms"]),
        torch.from_numpy(case["queries"]).bfloat16(),
        ivf_scan.block_diag_codebook(torch.from_numpy(case["codebook"]), 128),
        torch.from_numpy(case["centers_tile"]).bfloat16(), torch.from_numpy(case["qidx"]),
        torch.from_numpy(case["al"]), torch.from_numpy(case["lo"]),
        torch.from_numpy(case["sizes"]), W=W, m_tile=_GEOM["M"], ip=ip, cap=cap, book=book,
        bits=bits, mode=mode, sorted_fr=torch.from_numpy(case["fr"]) if rabitq else None,
        use_pen=use_pen, int8_mode=int8, pq_len=pq_len)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def _assert_pools(jv, ji, tv, ti, cap, int8):
    assert tv.shape == jv.shape == (4, 8, cap * 128) and ti.dtype == np.uint8
    assert np.isinf(tv[2]).all()  # the empty tile holds no candidate
    fin = np.isfinite(jv)
    assert np.array_equal(fin, np.isfinite(tv))
    close = np.abs(tv[fin] - jv[fin]) <= 1e-4 + 1e-5 * np.abs(jv[fin])
    if int8:
        assert close.mean() >= 0.999
    else:
        assert close.all()
    assert np.mean(ti == ji) > 0.999


# IVF-PQ keeps its codes in bytes whatever pq_bits (pack_codes_transposed):
# the scan reads 8-bit codes with a full book of 2^pq_bits entries
@pytest.mark.parametrize("pq_bits", [8, 4, 5, 6, 7])
@pytest.mark.parametrize("ip,use_pen", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cap", [2, 3, 7])
def test_pq_scan_pool_matches_pallas_pool_pq(ip, use_pen, int8, cap, pq_bits):
    if pq_bits == 8:  # the 8-bit cases as they were: a book of 16 at cap 2
        S, book, pq_len = (8, 16, 2) if cap == 2 else (4, 256, 3)
    else:
        S, book, pq_len = 8, 1 << pq_bits, 2
    case = pq_scan_case(10 * cap + 2 * ip + use_pen + 100 * (pq_bits != 8) * pq_bits, "pq", 8,
                        S, book, pq_len, use_pen=use_pen, **_GEOM)
    jv, ji, tv, ti = _both_scans(case, "pq", 8, book, pq_len, ip, use_pen, int8, cap)
    _assert_pools(jv, ji, tv, ti, cap, int8)


@pytest.mark.parametrize("bits", [1, 3, 8, 2, 4, 5])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("cap", [2, 3, 7])
def test_pq_scan_pool_matches_pallas_pool_rabitq(bits, ip, cap):
    S = 11  # dims; at 3 bits code 10 straddles two words
    case = pq_scan_case(bits + 5 * cap + ip, "rabitq", bits, S, 1 << bits, 1, **_GEOM)
    jv, ji, tv, ti = _both_scans(case, "rabitq", bits, 1 << bits, 1, ip, False, False, cap)
    _assert_pools(jv, ji, tv, ti, cap, False)


# The deep-bin kernel keeps its bins at a depth class D >= cap and writes
# the first cap levels. That is the cap-deep pool because the strict-> chain
# is prefix-stable: level r depends only on the inserted values and levels
# < r. Held here on the plain versions, with exact ties in every bin.
_DEPTHS = [(1, 2), (2, 4), (3, 4), (4, 8), (7, 8), (9, 16), (16, 32), (17, 32), (3, 32)]


@pytest.mark.parametrize("cap,depth", _DEPTHS)
def test_bin_chain_cut_to_cap_levels_is_the_cap_deep_chain(cap, depth):
    rng = np.random.default_rng(cap + 100 * depth)
    # 40 slices per bin, 6 distinct values: most insertions meet an equal entry
    v = torch.from_numpy(rng.integers(-3, 3, (2, 3, 40 * 128)).astype(np.float32))
    v[0, 0, ::7] = float("-inf")  # rows outside the list
    best, bidx = ops_ivf_scan._bin_insert(v, cap)
    deep_best, deep_bidx = ops_ivf_scan._bin_insert(v, depth)
    assert torch.equal(deep_best[..., :cap * 128], best)
    assert torch.equal(deep_bidx[..., :cap * 128], bidx)


# 16-slice windows, so that deep bins fill
_DEEP_GEOM = dict(al=[0, 512, 1024, 2048], lo=[5, 0, 0, 100], sizes=[2000, 1500, 0, 1900], M=8,
                  W=2048, n_pad=4096)


def _tied_case(seed, mode, bits, S, book, pq_len):
    """Small-integer codebooks, queries, centers and row factors (every sum
    exact) with codes repeating every 3 slices per lane bin: exact ties."""
    rng = np.random.default_rng(seed)
    case = pq_scan_case(seed, mode, bits, S, book, pq_len, **_DEEP_GEOM)
    src = np.arange(case["codes_t"].shape[1]) % 384
    case["codes_t"] = np.ascontiguousarray(case["codes_t"][:, src])
    if mode == "pq":
        case["codebook"] = rng.integers(-2, 3, case["codebook"].shape).astype(np.float32)
    for key in ("queries", "centers_tile"):
        case[key] = rng.integers(-3, 4, case[key].shape).astype(np.float32)
    case["norms"] = rng.integers(0, 16, src.size).astype(np.float32)[src]
    case["fr"] = rng.integers(-2, 3, src.size).astype(np.float32)[src]
    return case


@pytest.mark.parametrize("mode,bits,S,book,pq_len,int8", [("pq", 8, 8, 16, 2, False),
                                                          ("pq", 8, 8, 16, 2, True),
                                                          ("rabitq", 3, 11, 8, 1, False)])
@pytest.mark.parametrize("cap,depth", [(1, 2), (3, 4), (7, 8), (9, 16), (16, 32)])
def test_pq_scan_pool_cut_to_cap_levels_is_the_cap_deep_pool(mode, bits, S, book, pq_len, int8,
                                                             cap, depth):
    case = _tied_case(cap + depth + 3 * int8, mode, bits, S, book, pq_len)
    args = (torch.from_numpy(case["codes_t"].view(np.int32)), torch.from_numpy(case["norms"]),
            torch.from_numpy(case["queries"]).bfloat16(),
            ivf_scan.block_diag_codebook(torch.from_numpy(case["codebook"]), 128),
            torch.from_numpy(case["centers_tile"]).bfloat16(),
            *(torch.from_numpy(case[k]) for k in ("qidx", "al", "lo", "sizes")))
    kw = dict(W=_DEEP_GEOM["W"], m_tile=_DEEP_GEOM["M"], ip=False, book=book, bits=bits, mode=mode,
              sorted_fr=torch.from_numpy(case["fr"]) if mode == "rabitq" else None,
              int8_mode=int8, pq_len=pq_len)
    v, i = ops_ivf_scan.fused_pq_scan_reference(*args, cap=cap, **kw)
    dv, di = ops_ivf_scan.fused_pq_scan_reference(*args, cap=depth, **kw)
    assert torch.isfinite(v[:, :, (cap - 1) * 128:]).any()  # the last level holds rows
    assert torch.equal(dv[..., :cap * 128], v)
    assert torch.equal(di[..., :cap * 128], i)


def test_pq_scan_rejects_bad_operands():
    case = pq_scan_case(5, "pq", 8, 8, 16, 2, **_GEOM)
    words = torch.from_numpy(case["codes_t"].view(np.int32))
    q = torch.from_numpy(case["queries"]).bfloat16()
    cb = ivf_scan.block_diag_codebook(torch.from_numpy(case["codebook"]), 128)
    ct = torch.from_numpy(case["centers_tile"]).bfloat16()
    rest = [torch.from_numpy(case[k]) for k in ("qidx", "al", "lo", "sizes")]
    norms = torch.from_numpy(case["norms"])
    kw = dict(W=256, m_tile=8, ip=False, book=16, pq_len=2)
    with pytest.raises(TypeError):  # queries must be bf16
        ops_ivf_scan.fused_pq_scan(words, norms, q.float(), cb, ct, *rest, **kw)
    with pytest.raises(ValueError):  # rabitq needs f_rescale
        ops_ivf_scan.fused_pq_scan(words, norms, q, cb, ct, *rest, mode="rabitq", **kw)
    with pytest.raises(ValueError):  # too few word rows for 8 codes of 8 bits
        ops_ivf_scan.fused_pq_scan(words[:1], norms, q, cb, ct, *rest, **kw)
    with pytest.raises(ValueError):  # the codebook's block height is at least 1
        ops_ivf_scan.fused_pq_scan(words, norms, q, cb, ct, *rest, **{**kw, "pq_len": 0})


def test_pq_scan_needs_pq_len():
    """pq_len, the height of cb_t's diagonal blocks, has no default."""
    case = pq_scan_case(6, "pq", 8, 8, 16, 2, **_GEOM)
    args = (torch.from_numpy(case["codes_t"].view(np.int32)), torch.from_numpy(case["norms"]),
            torch.from_numpy(case["queries"]).bfloat16(),
            ivf_scan.block_diag_codebook(torch.from_numpy(case["codebook"]), 128),
            torch.from_numpy(case["centers_tile"]).bfloat16(),
            *(torch.from_numpy(case[k]) for k in ("qidx", "al", "lo", "sizes")))
    for fn in (ops_ivf_scan.fused_pq_scan, ops_ivf_scan.fused_pq_scan_reference):
        with pytest.raises(TypeError):
            fn(*args, W=256, m_tile=8, ip=False, book=16)
