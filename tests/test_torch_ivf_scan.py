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
