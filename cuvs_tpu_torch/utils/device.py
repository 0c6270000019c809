"""Where the port's entry points put their data.

The port runs on the CUDA card unless the caller asks for the CPU: a tensor
keeps its device (or moves to an explicit ``device``), and host data (numpy
arrays, lists, scalars) goes to ``device``, or to ``cuda`` when that is None.
Without a CUDA device, host data with ``device=None`` raises: nothing falls
back to the CPU on its own.
"""

from __future__ import annotations

import dataclasses

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


def _map(value, fn):
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, tuple) and hasattr(value, "_asdict"):  # SortedLists
        return type(value)(*(_map(v, fn) for v in value))
    if isinstance(value, tuple):  # the packed CAGRA's child_vecs pieces
        return tuple(_map(v, fn) for v in value)
    return value


def map_tensors(index, fn):
    """A copy of an index (a dataclass) with ``fn`` applied to every tensor it
    holds: its tensor fields, a SortedLists' arrays and tuples of tensors."""
    return dataclasses.replace(index, **{f.name: _map(getattr(index, f.name), fn)
                                         for f in dataclasses.fields(index) if f.init})


def index_to(index, device, non_blocking: bool = False):
    """The index with its tensors on ``device``. A tensor already there is
    kept, not copied (``Tensor.to`` returns it)."""
    return map_tensors(index, lambda t: t.to(device, non_blocking=non_blocking))
