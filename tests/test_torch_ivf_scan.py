"""Fused IVF scan (kernel 3) and pair tiling: the port's plain version against
the reference's Pallas kernel in interpret mode, on the CPU.

Tolerances: the pools are compared element for element. float32 and
bfloat16 (inputs rounded identically on both sides) values at rtol 1e-5 /
atol 1e-4, with ids equal except where two candidates tie within that; int8
pools are integer arithmetic and must be identical. group_pairs_tiled is
integer work and must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.neighbors import ivf_scan as jax_ivf_scan
from cuvs_tpu.ops import ivf_scan_pallas
from cuvs_tpu_torch.neighbors import ivf_scan
from cuvs_tpu_torch.ops import ivf_scan as ops_ivf_scan

torch.set_num_threads(1)


@pytest.mark.parametrize("nq,p,n_lists,m_tile", [(30, 5, 12, 8), (64, 8, 40, 16), (7, 3, 3, 128)])
def test_group_pairs_tiled_matches_reference(nq, p, n_lists, m_tile):
    rng = np.random.default_rng(nq)
    # skewed probes: a few lists take most pairs
    probe = np.minimum(rng.geometric(0.2, (nq, p)) - 1, n_lists - 1).astype(np.int32)
    n_tiles = nq * p // m_tile + min(n_lists, nq * p) + 1
    ref = jax_ivf_scan.group_pairs_tiled(jnp.asarray(probe), n_lists, m_tile, n_tiles)
    got = ivf_scan.group_pairs_tiled(torch.from_numpy(probe), n_lists, m_tile, n_tiles)
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        assert np.array_equal(np.asarray(r), g.numpy())


def test_round_window_up_matches_reference():
    for window, n_pad in [(128, 10_000), (3072, 100_000), (896, 1000), (384, 600)]:
        assert ivf_scan._round_window_up(window, n_pad) == \
            jax_ivf_scan._round_window_up(window, n_pad)


def _scan_inputs(rng, dtype, n_pad=1024):
    dp, nq, M = 128, 20, 8
    x = rng.standard_normal((n_pad, dp)).astype(np.float32)
    q = rng.standard_normal((nq, dp)).astype(np.float32)
    norms = np.pad((x * x).sum(1), (0, 4096)).astype(np.float32)
    if dtype == "int8":
        s = float(np.abs(x).max() / 127.0)
        xq = np.clip(np.round(x / s), -127, 127).astype(np.int8)
        qq = np.clip(np.round(q / s), -127, 127).astype(np.int8)
        return (xq, qq, jnp.asarray(xq), jnp.asarray(qq), torch.from_numpy(xq),
                torch.from_numpy(qq), norms, s * s)
    # "<rows>-<queries>q": the mixed pairs the wrapper widens to f32 products
    xdt, qdt = dtype.removesuffix("q").split("-") if "-" in dtype else (dtype, dtype)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    return (x, q, jnp.asarray(x, jdt[xdt]), jnp.asarray(q, jdt[qdt]),
            torch.from_numpy(x).to(tdt[xdt]), torch.from_numpy(q).to(tdt[qdt]), norms, 1.0)


# caps 1, 4 and 9: the card's cap-2 kernel writing one level, and the edges
# of its depth classes (4, 8 < 9 <= 16), over a 10-slice window whose lists
# fill more slices than the cap, so the chain drops entries
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "f32-bf16q", "bf16-f32q"])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("cap", [2, 3, 1, 4, 9])
def test_scan_pool_matches_pallas_pool(dtype, ip, cap):
    rng = np.random.default_rng(3 * cap + ip)
    n_tiles, M = 4, 8
    # tile 2 is empty (size 0); tiles 0 and 2 start past window position 0
    al = np.array([0, 128, 256, 512], np.int32)
    lo = np.array([5, 0, 100, 0], np.int32)
    if cap in (2, 3):
        W, n_pad, sizes = 384, 1024, np.array([200, 300, 0, 250], np.int32)
    else:
        W, n_pad, sizes = 1280, 2048, np.array([1200, 1280, 0, 1100], np.int32)
    _, _, jx, jq, tx, tq, norms, scale2 = _scan_inputs(rng, dtype, n_pad)
    qidx = rng.integers(-1, 20, (n_tiles, M)).astype(np.int32)  # -1 = empty slot
    jv, ji = ivf_scan_pallas.fused_ivf_scan(
        jx, norms, jq, qidx, al, lo, sizes, jnp.float32(scale2), W=W, m_tile=M, inner=128,
        ip=ip, int8_mode=dtype == "int8", cap=cap, interpret=True)
    tv, ti = ops_ivf_scan.fused_ivf_scan(
        tx, torch.from_numpy(norms), tq, torch.from_numpy(qidx), torch.from_numpy(al),
        torch.from_numpy(lo), torch.from_numpy(sizes), scale2, W=W, m_tile=M, ip=ip,
        int8_mode=dtype == "int8", cap=cap)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert tv.shape == (n_tiles, M, cap * 128) and ti.dtype == torch.uint8
    assert np.isinf(tv.numpy()[2]).all()  # the empty tile holds no candidate
    if dtype == "int8":
        assert np.array_equal(tv.numpy(), jv) and np.array_equal(ti.numpy(), ji)
        return
    fin = np.isfinite(jv)
    assert np.array_equal(fin, np.isfinite(tv.numpy()))
    np.testing.assert_allclose(tv.numpy()[fin], jv[fin], rtol=1e-5, atol=1e-4)
    assert np.mean(ti.numpy() == ji) > 0.999


def test_scan_rejects_mismatched_dtypes():
    x = torch.zeros((256, 128), dtype=torch.int8)
    with pytest.raises(TypeError):
        ops_ivf_scan.fused_ivf_scan(
            x, torch.zeros(512), torch.zeros((2, 128)), torch.zeros((1, 8), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 1.0, W=128, m_tile=8, ip=False,
            int8_mode=False)


# The three families' scan-path rules as their searches wrote them before
# ivf_scan.scan_path: (algo, large batch, fused_ok, on_cuda) -> path. A
# "bogus" algo raised in every family before anything else.
def _old_flat_pq(algo, big, fused_ok, on_cuda):
    """ivf_flat.search (no metric UDF) and ivf_pq.search."""
    if algo == "auto":
        algo = ("fused" if fused_ok and on_cuda else "cluster_major") if big else "query_major"
    if algo == "fused" and not fused_ok:
        algo = "cluster_major"
    return algo


def _old_rabitq(algo, big, fused_ok, on_cuda):
    """ivf_rabitq.search."""
    if algo == "auto":
        algo = "fused" if big and on_cuda and fused_ok else "query_major"
    if algo == "fused" and not fused_ok:
        algo = "query_major"
    return algo


def _old_flat_udf(algo, big, fused_ok, on_cuda):
    """ivf_flat.search with a metric UDF: the fused kernel has no UDF epilogue."""
    if algo in ("auto", "fused"):
        return "cluster_major" if big else "query_major"
    return algo


# family -> (its old rule, the fallback its search passes, whether it maps a
# metric UDF's "fused" to "auto" with fused_ok False, as ivf_flat.search does)
OLD_RULES = {"ivf_flat": (_old_flat_pq, "cluster_major", False),
             "ivf_pq": (_old_flat_pq, "cluster_major", False),
             "ivf_rabitq": (_old_rabitq, "query_major", False),
             "ivf_flat_udf": (_old_flat_udf, "cluster_major", True)}


@pytest.mark.parametrize("family", list(OLD_RULES))
@pytest.mark.parametrize("on_cuda", [False, True])
@pytest.mark.parametrize("fused_ok", [False, True])
@pytest.mark.parametrize("nq", [15, 16])  # 15 x 4 probes < 4 x 16 lists <= 16 x 4
@pytest.mark.parametrize("algo", ["auto", "query_major", "cluster_major", "fused", "bogus"])
def test_scan_path_is_each_familys_old_rule(algo, nq, fused_ok, on_cuda, family):
    old, fallback, udf = OLD_RULES[family]
    n_probes, n_lists = 4, 16
    if udf:
        algo, fused_ok_passed = ("auto" if algo == "fused" else algo), False
    else:
        fused_ok_passed = fused_ok
    if algo == "bogus":
        with pytest.raises(ValueError, match="scan_algo 'bogus'"):
            ivf_scan.scan_path(algo, nq, n_probes, n_lists, fused_ok_passed, on_cuda, fallback)
        return
    want = old(algo, nq * n_probes >= 4 * n_lists, fused_ok, on_cuda)
    assert ivf_scan.scan_path(algo, nq, n_probes, n_lists, fused_ok_passed, on_cuda,
                              fallback) == want


@pytest.mark.parametrize("nq,p,n_lists", [(1, 3, 5), (30, 5, 12), (300, 7, 4), (1000, 20, 64)])
def test_tile_geometry_drops_no_pair(nq, p, n_lists):
    rng = np.random.default_rng(nq + p)
    # skewed probes: a few lists take most pairs
    probe = torch.from_numpy(np.minimum(rng.geometric(0.3, (nq, p)) - 1,
                                        n_lists - 1).astype(np.int32))
    m_tile, n_tiles = ivf_scan.tile_geometry(nq, p, n_lists)
    assert 8 <= m_tile <= 128
    tile_cluster, _, pair_tile, _ = ivf_scan.group_pairs_tiled(probe, n_lists, m_tile, n_tiles)
    assert bool((pair_tile < n_tiles).all())
    assert tile_cluster.shape == (n_tiles,)


def test_scan_compare_phases_name_what_the_fused_searches_call():
    """bench/scan_compare.py splits a search into stages by replacing the
    functions its PHASES name: each must exist, and a fused IVF-Flat and
    IVF-PQ search must call every one."""
    from cuvs_tpu_torch.bench import scan_compare
    from cuvs_tpu_torch.neighbors import ivf_flat, ivf_pq

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1500, 32))
                         .astype(np.float32))
    flat = ivf_flat.build(x, n_lists=8, seed=0)
    pq = ivf_pq.build(x, n_lists=8, pq_dim=8, pq_bits=4, seed=0)
    named = {(phase, attr) for phase, fns in scan_compare.PHASES.items() for _, attr in fns}
    assert all(callable(getattr(mod, attr))
               for fns in scan_compare.PHASES.values() for mod, attr in fns)
    called = set()

    def wrap(phase, f):
        def counted(*args, **kw):
            called.add((phase, f.__name__))
            return f(*args, **kw)
        return counted

    with scan_compare.patched(wrap):
        ivf_flat.search(flat, x[:20], 5, n_probes=4, scan_algo="fused")
        ivf_pq.search(pq, x[:20], 5, n_probes=4, scan_algo="fused")
    assert called == named
