"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: float32 and bfloat16 pools are compared at rtol 1e-5 / atol 1e-4
(the kernel and the plain version sum the same exact products in another
order); int8 pools are integer arithmetic and must be identical. Ids must be
equal except where two candidates' values tie within that tolerance.
"""

import numpy as np
import pytest
import torch

from cuvs_tpu_torch.ops import bf_topk, ivf_scan

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


# rows and queries: one dtype, or bf16 rows with f32 queries (bf16 storage
# searched at f32 compute)
@pytest.mark.parametrize("dtype,qdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.int8, torch.int8),
                                          (torch.bfloat16, torch.float32)])
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


def test_launch_counters_count_kernel_launches(cuda):
    before = dict(bf_topk.LAUNCHES)
    q = _data(np.random.default_rng(1), 8, 32, torch.float32, cuda)
    bf_topk.fused_bf_topk(q, q, 4, exact=True)
    bf_topk.fused_bf_topk(q.cpu(), q.cpu(), 4, exact=True)  # plain version: not counted
    assert bf_topk.LAUNCHES["bf_topk_exact"] == before["bf_topk_exact"] + 1


def test_ivf_build_is_reproducible(cuda):
    from cuvs_tpu_torch.neighbors import ivf_flat

    x = _data(np.random.default_rng(5), 60000, 32, torch.float32, cuda)
    a = ivf_flat.build(x, n_lists=64, seed=0)
    b = ivf_flat.build(x, n_lists=64, seed=0)
    assert torch.equal(a.centers, b.centers)
    assert torch.equal(a.lists.ids, b.lists.ids)
