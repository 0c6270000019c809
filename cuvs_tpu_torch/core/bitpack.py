"""Bit-packed fixed-width code storage — port of ``cuvs_tpu.core.bitpack``.

Same layout as the reference: the codes of one vector are packed
little-endian into a row of 32-bit words, code ``s`` at bits
``[s*bits, (s+1)*bits)``, a code that crosses a word boundary continuing in
the low bits of the next word.

PyTorch does not shift or add uint32 tensors on the CPU, so a word is held as
int32 with the same bit pattern (as ``core.bitset`` does) and all arithmetic
runs in int64 on the unsigned value. ``pack`` returns int32 words; ``unpack``
takes int32 words, uint32 words or a uint32 numpy array.
"""

from __future__ import annotations

import numpy as np
import torch

from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.device import resolve_device

WORD = 32
_U32_MASK = 0xFFFFFFFF


def packed_words(n_codes: int, bits: int) -> int:
    """32-bit words needed for ``n_codes`` codes of ``bits`` bits."""
    return (n_codes * bits + WORD - 1) // WORD


def packed_bytes(n_codes: int, bits: int) -> int:
    """Reference-parity byte count of one packed row."""
    return packed_words(n_codes, bits) * 4


def _as_unsigned(words, device=None) -> torch.Tensor:
    """Words (int32 bit patterns, uint32 tensor or numpy array) as their
    unsigned values in int64. Host words go to ``device`` (None: the card)."""
    if not isinstance(words, torch.Tensor):
        words = torch.from_numpy(np.array(words, np.uint32).view(np.int32)).to(
            resolve_device(device))
    elif device is not None:
        words = words.to(device)
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    return words.to(torch.int64) & _U32_MASK


def _to_words(values: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> int32 words, same bits."""
    return (values - ((values >> 31) << 32)).to(torch.int32)


def _positions(n_codes: int, bits: int, device):
    lo = torch.arange(n_codes, dtype=torch.int64, device=device) * bits
    return lo // WORD, lo % WORD


def pack(codes, bits: int, device=None) -> torch.Tensor:
    """Pack integer codes [..., S] (each < 2**bits) into [..., W] int32 words.
    Host codes go to ``device`` (None: the CUDA card)."""
    if not 1 <= bits <= 32:
        raise ValueError("bits must be in [1, 32]")
    c = _on_device(codes, device).to(torch.int64) & ((1 << bits) - 1)
    S = c.shape[-1]
    w0, sh = _positions(S, bits, c.device)
    out = torch.zeros(c.shape[:-1] + (packed_words(S, bits),), dtype=torch.int64,
                      device=c.device)
    # bit ranges are disjoint, so adding the shifted codes is OR-ing them
    out.index_add_(-1, w0, (c << sh) & _U32_MASK)
    spill = sh + bits > WORD  # the code continues in the next word
    if bool(spill.any()):
        idx = spill.nonzero()[:, 0]
        out.index_add_(-1, w0[idx] + 1, c[..., idx] >> (WORD - sh[idx]))
    return _to_words(out)


def unpack(packed, bits: int, n_codes: int, device=None) -> torch.Tensor:
    """Unpack [..., W] words into int32 codes [..., n_codes]. Host words go to
    ``device`` (None: the CUDA card)."""
    p = _as_unsigned(packed, device)
    w0, sh = _positions(n_codes, bits, p.device)
    v = p[..., w0] >> sh
    spill = sh + bits > WORD
    if bool(spill.any()):
        nxt = p[..., torch.clamp_max(w0 + 1, p.shape[-1] - 1)] << (WORD - sh)
        v = v | torch.where(spill, nxt, 0)
    return (v & ((1 << bits) - 1)).to(torch.int32)
