"""Fused brute-force kernels (kernels 1, 2 and 2b): the port's plain versions
against the reference's Pallas kernels in interpret mode, on the CPU.

Tolerances: float32 distances rtol 1e-5 / atol 1e-4 (same products, another
summation order); bfloat16 inputs are rounded identically on both sides and
compared in float32 at rtol 1e-3; int8 pools and results are integer
arithmetic and must be identical. Ids must be equal except where two
candidates' distances tie within the tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cuvs_tpu.distance.pairwise import DistanceType as JDistanceType
from cuvs_tpu.ops import bf_topk_pallas
from cuvs_tpu_torch.distance.pairwise import DistanceType
from cuvs_tpu_torch.ops import bf_topk
from tests.torch_parity import ids_match_modulo_ties

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=1e-3, atol=1e-3)


def _quantized(x, scale):
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8)


@pytest.mark.parametrize("metric", [0, 1, 6])  # L2, L2Sqrt, InnerProduct
@pytest.mark.parametrize("k", [1, 10, 64])
def test_exact_matches_pallas(metric, k):
    rng = np.random.default_rng(10 * metric + k)
    x = rng.standard_normal((1500, 16)).astype(np.float32)  # 1500 = 2 tiles of 1024, padded
    q = rng.standard_normal((24, 16)).astype(np.float32)
    jd, ji = bf_topk_pallas.search(x, None, q, k, metric=JDistanceType(metric),
                                   compute_dtype=jnp.float32, tile_n=1024, interpret=True)
    td, ti = bf_topk.search(torch.from_numpy(x), None, torch.from_numpy(q), k,
                            metric=DistanceType(metric), compute_dtype=torch.float32,
                            tile_n=1024)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **F32_TOL)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), **F32_TOL)
    assert ti.dtype == torch.int32 and (ti.numpy() < 1500).all()


def _pallas_exact_pool(q, x, k, tile_n, ip):
    """The reference's _fused_kernel pool [n_tiles, B, k] (interpret mode)."""
    B, d = q.shape
    N = x.shape[0]
    n_tiles = -(-N // tile_n)
    xp = jnp.pad(x, ((0, n_tiles * tile_n - N), (0, 0)))
    kern = functools.partial(bf_topk_pallas._fused_kernel, k=k, n=N, tile_n=tile_n, ip=ip,
                             exact=True)
    out_v, out_i = pl.pallas_call(
        kern, grid=(1, n_tiles),
        in_specs=[pl.BlockSpec((B, d), lambda i, t: (i, 0)),
                  pl.BlockSpec((tile_n, d), lambda i, t: (t, 0))],
        out_specs=[pl.BlockSpec((1, B, k), lambda i, t: (t, i, 0))] * 2,
        out_shape=[jax.ShapeDtypeStruct((n_tiles, B, k), jnp.float32),
                   jax.ShapeDtypeStruct((n_tiles, B, k), jnp.int32)],
        interpret=True)(q, xp)
    return np.asarray(out_v), np.asarray(out_i)


@pytest.mark.parametrize("ip", [False, True])
def test_exact_pool_matches_pallas_pool(ip):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((700, 16)).astype(np.float32)  # last tile: 188 rows + padding
    q = rng.standard_normal((8, 16)).astype(np.float32)
    k, tile_n = 5, 256
    jv, ji = _pallas_exact_pool(q, x, k, tile_n, ip)
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    tv, ti = bf_topk.bf_topk_exact(tq, tx, tq.pow(2).sum(1), tx.pow(2).sum(1), k, tile_n, ip)
    np.testing.assert_allclose(tv.numpy(), jv, **F32_TOL)
    assert np.array_equal(ti.numpy(), ji)


def _pallas_approx_pool(q, x, pen, tile_n, key_pack):
    """The reference's _approx_kernel pool [n_tiles, B, 128] (interpret mode)."""
    B, d = q.shape
    N = x.shape[0]
    n_tiles, C, _ = pen.shape
    xp = jnp.pad(x, ((0, n_tiles * tile_n - N), (0, 0)))
    out_v, out_i = pl.pallas_call(
        functools.partial(bf_topk_pallas._approx_kernel, mxu_n=tile_n, key_pack=key_pack),
        grid=(n_tiles, 1),
        in_specs=[pl.BlockSpec((B, d), lambda t, i: (i, 0)),
                  pl.BlockSpec((1, C, 128), lambda t, i: (t, 0, 0)),
                  pl.BlockSpec((tile_n, d), lambda t, i: (t, 0))],
        out_specs=[pl.BlockSpec((1, B, 128), lambda t, i: (t, i, 0))] * 2,
        out_shape=[jax.ShapeDtypeStruct((n_tiles, B, 128), jnp.float32),
                   jax.ShapeDtypeStruct((n_tiles, B, 128), jnp.uint8)],
        interpret=True)(q, pen, xp)
    return np.asarray(out_v), np.asarray(out_i)


def _approx_inputs(rng, dtype, d, n=5000, nq=16):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    if dtype == "int8":
        scale = float(np.abs(x).max() / 127.0)
        return _quantized(q, scale), _quantized(x, scale), torch.int8, jnp.int8
    if dtype == "bf16":
        return q, x, torch.bfloat16, jnp.bfloat16
    return q, x, torch.float32, jnp.float32


# d=16 takes the int8 key-pack branch, d=256 the compare/select chain
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [16, 256])
def test_approx_pool_matches_pallas_pool(dtype, d):
    rng = np.random.default_rng(d)
    q, x, tdt, jdt = _approx_inputs(rng, dtype, d)
    tq, tx = torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt)
    tile_n = 4096  # two tiles, the second padded
    n_tiles = -(-x.shape[0] // tile_n)
    key_pack = dtype == "int8" and 4 * d * 16129 * 256 < 2 ** 31
    assert key_pack == (dtype == "int8" and d == 16)
    pen = bf_topk._penalty(tx, None, n_tiles, tile_n, False, key_pack)
    tv, ti = bf_topk.bf_topk_approx(tq, tx, pen, tile_n, key_pack)
    jq, jx = jnp.asarray(q, jdt), jnp.asarray(x, jdt)
    jv, ji = _pallas_approx_pool(jq, jx, jnp.asarray(pen.numpy()), tile_n, key_pack)
    if dtype == "int8":
        assert np.array_equal(tv.numpy(), jv) and np.array_equal(ti.numpy(), ji)
    else:
        np.testing.assert_allclose(tv.numpy(), jv, **(F32_TOL if dtype == "f32" else BF16_TOL))
        assert np.mean(ti.numpy() == ji) > 0.999


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [16, 256])
@pytest.mark.parametrize("metric", [0, 6])
def test_approx_search_matches_pallas(dtype, d, metric):
    rng = np.random.default_rng(7 * d + metric)
    x = rng.standard_normal((5000, d)).astype(np.float32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    kw = dict(metric=JDistanceType(metric), exact=False, interpret=True)
    tkw = dict(metric=DistanceType(metric), exact=False)
    if dtype == "int8":
        scale = float(np.abs(x).max() / 127.0)
        x8 = _quantized(x, scale)
        jd, ji = bf_topk_pallas.search(x8, None, q, 10, q_scale=scale, **kw)
        td, ti = bf_topk.search(torch.from_numpy(x8), None, torch.from_numpy(q), 10,
                                q_scale=scale, **tkw)
        assert np.array_equal(td.numpy(), np.asarray(jd))
        ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 0.0, 0.0)
        return
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    jd, ji = bf_topk_pallas.search(x, None, q, 10, compute_dtype=jdt, **kw)
    td, ti = bf_topk.search(torch.from_numpy(x), None, torch.from_numpy(q), 10,
                            compute_dtype=tdt, **tkw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **tol)
    ids_match_modulo_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), **tol)


def test_fused_rejects_bad_metric():
    with pytest.raises(ValueError):
        bf_topk.search(torch.zeros((10, 4)), None, torch.zeros((2, 4)), 2,
                       metric=DistanceType.CosineExpanded)


def test_cpu_tensors_never_launch_a_kernel():
    before = dict(bf_topk.LAUNCHES)
    x = torch.randn(300, 8)
    bf_topk.search(x, None, x[:5], 3, compute_dtype=torch.float32)
    bf_topk.search(x, None, x[:5], 3, exact=False)
    assert bf_topk.LAUNCHES == before
