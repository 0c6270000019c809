"""Execution resources handle — port of ``cuvs_tpu.core.resources``.

The reference threads a ``raft::resources`` handle (CUDA stream, workspace
memory resource, NCCL comms) through every call
(ivf_flat_search.cuh:57). In the port PyTorch owns streams and memory, so the
handle is a light execution policy: the target device, the default compute
dtype of the distance products, the devices a multi-device (``mg``) call
takes, and a batching knob. Every API works without one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from cuvs_tpu_torch.utils.device import as_tensor


@dataclasses.dataclass(frozen=True)
class Resources:
    """Execution policy for cuvs_tpu_torch calls.

    Attributes:
      device: target ``torch.device`` (None: the CUDA card, through
        ``utils/device.resolve_device``, which raises without one).
      compute_dtype: dtype of the distance products' operands (bfloat16 for
        throughput, float32 for accuracy).
      devices: the devices of multi-device (``mg``) calls (None: every CUDA
        device).
      query_batch: internal query batch of memory-bounded search loops (the
        analog of ivf_pq max_internal_batch_size=4096, ivf_pq.hpp:212).
    """

    device: Optional[Any] = None
    compute_dtype: Any = torch.float32
    devices: Optional[Sequence] = None
    query_batch: int = 4096

    def put(self, x) -> torch.Tensor:
        """``x`` as a tensor on this handle's device (None: a tensor stays
        where it is, host data goes to the card)."""
        return as_tensor(x, self.device)


_DEFAULT = Resources()


def default_resources() -> Resources:
    return _DEFAULT


def get(res: Optional[Resources]) -> Resources:
    return res if res is not None else _DEFAULT
