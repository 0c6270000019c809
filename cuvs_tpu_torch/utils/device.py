"""Where the port's entry points put their data.

The port runs on the CUDA card unless the caller asks for the CPU: a tensor
keeps its device (or moves to an explicit ``device``), and host data (numpy
arrays, lists, scalars) goes to ``device``, or to ``cuda`` when that is None.
Without a CUDA device, host data with ``device=None`` raises: nothing falls
back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("cuvs_tpu_torch runs on the CUDA card by default and found no CUDA "
                           "device; pass device='cpu' (or CPU tensors) to run on the host")
    return torch.device("cuda")


def as_tensor(data, device=None) -> torch.Tensor:
    """A tensor on the port's device: a tensor stays where it is unless
    ``device`` is given; host data goes to ``device`` (None: the card)."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    return torch.as_tensor(data, device=resolve_device(device))
