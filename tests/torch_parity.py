"""Comparison helper for the port's parity tests (numpy only)."""

import numpy as np


def ids_match_modulo_ties(ids_a, ids_b, dists, rtol=1e-5, atol=1e-4):
    """Assert two [nq, k] id lists agree wherever the distance at that rank is
    not tied, within rtol/atol, with a neighbouring rank. The last rank may
    tie a candidate that did not make the cut, so it is not compared."""
    ids_a, ids_b, dists = np.asarray(ids_a), np.asarray(ids_b), np.asarray(dists, np.float64)
    tol = atol + rtol * np.abs(dists)
    close = np.abs(np.diff(dists, axis=1)) <= tol[:, 1:]
    tied = np.zeros(dists.shape, bool)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    tied[:, -1] = True
    assert np.all((ids_a == ids_b) | tied)


def pq_scan_case(seed, mode, bits, S, book, pq_len, al, lo, sizes, M, W, n_pad, nq=20, dp=128,
                 use_pen=False, word_pad=0):
    """Seeded numpy inputs of one fused quantized-code scan (``fused_pq_scan``).

    mode "pq": ``S`` subspaces of ``pq_len`` dims, codes < ``book`` stored as
    bytes (8 bits each); mode "rabitq": ``S`` dims, codes of ``bits`` bits,
    the codebook the centred levels. Returns a dict of numpy arrays: codes_t
    [Sw + word_pad, n_pad] uint32, codebook [S, book, pq_len], queries
    [nq, dp] and centers_tile [n_tiles, dp] f32 (both sides round them to
    bf16), norms (pq: decoded norms, or a 0/+inf penalty with ``use_pen``;
    rabitq: fa), fr, qidx [n_tiles, M] with empty slots, al, lo, sizes."""
    import torch

    from cuvs_tpu_torch.core import bitpack

    rng = np.random.default_rng(seed)
    pack_bits = 8 if mode == "pq" else bits
    codes = rng.integers(0, book, (n_pad, S))
    words = bitpack.pack(torch.from_numpy(codes), pack_bits).numpy().view(np.uint32).T
    words = np.pad(words, ((0, word_pad), (0, 0)))
    if mode == "pq":
        codebook = rng.standard_normal((S, book, pq_len)).astype(np.float32)
    else:
        levels = np.arange(book, dtype=np.float32) - ((1 << bits) - 1) / 2.0
        codebook = np.broadcast_to(levels[None, :, None], (S, book, 1)).copy()
    if use_pen:
        norms = np.where(rng.random(n_pad) < 0.3, np.inf, 0.0).astype(np.float32)
    else:
        norms = rng.uniform(1.0, 20.0, n_pad).astype(np.float32)
    n_tiles = len(al)
    return dict(
        codes_t=np.ascontiguousarray(words), codebook=codebook,
        queries=rng.standard_normal((nq, dp)).astype(np.float32),
        centers_tile=rng.standard_normal((n_tiles, dp)).astype(np.float32),
        norms=norms, fr=rng.uniform(-2.0, 2.0, n_pad).astype(np.float32),
        qidx=rng.integers(-1, nq, (n_tiles, M)).astype(np.int32),
        al=np.asarray(al, np.int32), lo=np.asarray(lo, np.int32),
        sizes=np.asarray(sizes, np.int32))


def pool_case(seed, nq, p, F, M=8, tied=False, offsets=False, dropped=0.05, inf_share=0.1,
              inf_rows=0.05):
    """Seeded numpy operands of one pool merge (``ops.pool_topk``): a scan's
    pool ``out_v`` [n_tiles, M, F] f32 and in-bin slices ``out_i`` uint8,
    each (query, probe) pair on a slot of its own (``pair_tile``,
    ``pair_slot`` [nq, p] int32; a ``dropped`` share of the pairs on tile
    n_tiles), +inf on an ``inf_share`` of the entries and on whole rows
    (``inf_rows``), the last query's pairs all dropped or +inf, and per-pair
    offsets ``offs`` [nq, p] f32 (None without ``offsets``). ``tied``: small
    integer values and offsets, so entries tie within and across rows, with
    both signs of zero. Also ``al`` [n_tiles] int32 window starts (multiples
    of 128) and ``ids`` [al.max() + 4*128] int32 global ids."""
    rng = np.random.default_rng(seed)
    n_tiles = -(-nq * p // M) + 1
    slots = rng.permutation(n_tiles * M)[:nq * p]
    pair_tile = (slots // M).reshape(nq, p).astype(np.int32)
    pair_slot = (slots % M).reshape(nq, p).astype(np.int32)
    drop = rng.random((nq, p)) < dropped
    drop[-1, ::2] = True
    pair_tile[drop] = n_tiles
    if tied:
        out_v = rng.integers(-4, 5, (n_tiles, M, F)).astype(np.float32)
        out_v[out_v == 0] = np.where(rng.random(int((out_v == 0).sum())) < 0.5, -0.0, 0.0)
    else:
        out_v = rng.standard_normal((n_tiles, M, F)).astype(np.float32)
    out_v[rng.random(out_v.shape) < inf_share] = np.inf
    out_v[rng.random((n_tiles, M)) < inf_rows] = np.inf
    kept = pair_tile[-1] < n_tiles
    out_v[pair_tile[-1, kept], pair_slot[-1, kept]] = np.inf
    offs = None
    if offsets:
        offs = (rng.integers(0, 3, (nq, p)) if tied else
                rng.standard_normal((nq, p)) * 2).astype(np.float32)
    out_i = rng.integers(0, 4, (n_tiles, M, F)).astype(np.uint8)
    al = (rng.integers(0, 8, n_tiles) * 128).astype(np.int32)
    ids = rng.permutation(int(al.max()) + 4 * 128).astype(np.int32)
    return dict(out_v=out_v, out_i=out_i, pair_tile=pair_tile, pair_slot=pair_slot, offs=offs,
                al=al, ids=ids)
