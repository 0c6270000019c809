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
