"""Sample filters for prefiltered search — port of ``cuvs_tpu.neighbors.filters``.

A filter is a small dataclass: ``none``, ``bitset`` (one shared bit per
dataset row), ``bitmap`` (a bit per query and row) or ``udf`` (a callable
``fn(query_ids, sample_ids) -> bool`` tensor, evaluated eagerly).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cuvs_tpu_torch.core import bitset


@dataclasses.dataclass(frozen=True)
class Prefilter:
    """A search prefilter."""

    kind: str = "none"
    bits: Optional[torch.Tensor] = None  # int32 words (bitset.as_words)
    fn: Optional[Callable] = None

    @property
    def is_none(self) -> bool:
        return self.kind == "none"


def no_filter() -> Prefilter:
    return Prefilter(kind="none")


def bitset_filter(bits) -> Prefilter:
    """Shared filter: bit i set => dataset row i may be returned."""
    return Prefilter(kind="bitset", bits=bitset.as_words(bits))


def bitmap_filter(bits) -> Prefilter:
    """Per-query filter: bits [n_queries, ceil(n/32)]."""
    return Prefilter(kind="bitmap", bits=bitset.as_words(bits))


def udf_filter(fn: Callable) -> Prefilter:
    """UDF filter: fn(query_ids, sample_ids) -> bool mask (broadcastable)."""
    return Prefilter(kind="udf", fn=fn)


def from_mask(mask) -> Prefilter:
    """A bitset (1-D) or bitmap (2-D) filter from a boolean mask."""
    mask = torch.as_tensor(mask, dtype=torch.bool)
    if mask.ndim == 1:
        return Prefilter(kind="bitset", bits=bitset.bitset_from_mask(mask))
    return Prefilter(kind="bitmap", bits=bitset.bitmap_from_mask(mask))


def passes(flt: Optional[Prefilter], query_ids, sample_ids) -> Optional[torch.Tensor]:
    """Boolean mask of samples passing the filter, or None for no filter.

    query_ids broadcasts against sample_ids (global dataset row ids)."""
    if flt is None or flt.is_none:
        return None
    if flt.kind == "bitset":
        return bitset.bitset_test(flt.bits.to(torch.as_tensor(sample_ids).device), sample_ids)
    if flt.kind == "bitmap":
        bits = flt.bits.to(torch.as_tensor(sample_ids).device)
        return bitset.bitmap_test(bits, query_ids, sample_ids)
    if flt.kind == "udf":
        return torch.as_tensor(flt.fn(query_ids, sample_ids), dtype=torch.bool)
    raise ValueError(f"unknown filter kind {flt.kind}")
