"""Packed bit arrays used as search filters — port of ``cuvs_tpu.core.bitset``.

Same bit layout as the reference: 32-bit words, little-endian within a word
(bit i of sample j lives at word ``j // 32``, bit ``j % 32``); a set bit means
the sample may be returned. PyTorch has no full uint32 arithmetic, so words
are held as int32 with the same bit pattern: ``(word >> bit) & 1`` reads the
same bit under the arithmetic shift. ``as_words`` takes the reference's
uint32 arrays unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from cuvs_tpu_torch.utils.device import as_tensor as _on_device
from cuvs_tpu_torch.utils.device import resolve_device

BITS = 32


def num_words(n_bits: int) -> int:
    return (n_bits + BITS - 1) // BITS


def as_words(bits) -> torch.Tensor:
    """A uint32 numpy array, or an int32 tensor, as int32 words."""
    if isinstance(bits, torch.Tensor):
        return bits.to(torch.int32)
    return torch.from_numpy(np.array(bits, np.uint32).view(np.int32))


def bitset_create(n_bits: int, default: bool = True, device=None) -> torch.Tensor:
    """A bitset covering ``n_bits`` samples, all set or all cleared, on
    ``device`` (None: the CUDA card)."""
    return torch.full((num_words(n_bits),), -1 if default else 0, dtype=torch.int32,
                      device=resolve_device(device))


def bitset_from_mask(mask, device=None) -> torch.Tensor:
    """Pack a boolean [..., n] mask into [..., ceil(n/32)] int32 words. A
    host mask goes to ``device`` (None: the CUDA card)."""
    mask = _on_device(mask, device).to(torch.bool)
    n = mask.shape[-1]
    pad = (-n) % BITS
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, pad))
    m = m.reshape(*mask.shape[:-1], num_words(n), BITS)
    weights = torch.ones(BITS, dtype=torch.int64, device=m.device) << torch.arange(
        BITS, device=m.device)
    words = (m * weights).sum(-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)  # uint32 pattern as int32


def bitset_to_mask(bitset: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Unpack a bitset into a boolean [..., n_bits] mask."""
    shifts = torch.arange(BITS, dtype=torch.int32, device=bitset.device)
    bits = (bitset[..., :, None] >> shifts) & 1
    flat = bits.reshape(*bitset.shape[:-1], -1)
    return flat[..., :n_bits].to(torch.bool)


def bitset_test(bitset: torch.Tensor, ids) -> torch.Tensor:
    """Test bits at integer ``ids`` (any shape). Returns bool of ids.shape."""
    ids = torch.as_tensor(ids, device=bitset.device).long()
    word = bitset[ids // BITS]
    return ((word >> (ids % BITS).to(torch.int32)) & 1).to(torch.bool)


def bitset_set(bitset: torch.Tensor, ids, value: bool = True) -> torch.Tensor:
    """A new bitset with the bits at ``ids`` set or cleared (duplicates allowed)."""
    ids = torch.as_tensor(ids, device=bitset.device).reshape(-1).long()
    mask = bitset_to_mask(bitset, bitset.shape[0] * BITS).clone()
    mask[ids] = bool(value)
    return bitset_from_mask(mask)


def bitset_count(bitset: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Population count of the first ``n_bits`` bits."""
    return bitset_to_mask(bitset, n_bits).sum()


def bitmap_from_mask(mask, device=None) -> torch.Tensor:
    """Pack a boolean [n_queries, n] mask into [n_queries, ceil(n/32)]."""
    return bitset_from_mask(mask, device)


def bitmap_test(bitmap: torch.Tensor, query_ids, ids) -> torch.Tensor:
    """Test bitmap[query_ids, ids]; query_ids broadcast against ids."""
    ids = torch.as_tensor(ids, device=bitmap.device).long()
    query_ids = torch.as_tensor(query_ids, device=bitmap.device).long()
    word = bitmap[query_ids, ids // BITS]
    return ((word >> (ids % BITS).to(torch.int32)) & 1).to(torch.bool)
