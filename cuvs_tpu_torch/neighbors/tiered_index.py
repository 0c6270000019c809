"""Tiered index: a brute-force hot tier in front of an ANN tier — port of
``cuvs_tpu.neighbors.tiered_index``.

``cuvs::neighbors::tiered_index`` (tiered_index.hpp:62, min_ann_rows=100000;
state machine tiered_index.cuh:33-183). New rows land in the brute-force
hot tier; once ``min_ann_rows`` rows are there and no ANN tier exists, the
ANN tier is built over them; search fans out to both tiers and merges the
top-k; ``compact()`` folds the hot tier into the ANN tier. The hot tier
lives on the index's device and is searched by the fused exact kernel
(``brute_force.search(fused=True)``) for L2/IP and k <= 64.

As in the reference (tiered_index.py:103-105), a prefilter applies to the
ANN tier only: the hot tier is searched with none.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from cuvs_tpu_torch.distance.pairwise import is_min_close
from cuvs_tpu_torch.neighbors import brute_force
from cuvs_tpu_torch.selection.select_k import merge_parts
from cuvs_tpu_torch.utils import serialize as ser
from cuvs_tpu_torch.utils.device import as_tensor as _on_device

MAGIC = "cuvs_tpu.tiered_index"


@dataclasses.dataclass
class TieredIndex:
    module: object  # ANN module (cagra / ivf_flat / ivf_pq / ivf_sq)
    ann_params: object
    min_ann_rows: int = 100_000
    metric: str = "sqeuclidean"
    ann_index: Optional[object] = None
    ann_rows: int = 0
    bf_data: Optional[torch.Tensor] = None  # hot-tier rows (ids follow ann)
    device: Optional[torch.device] = None  # where host rows go (None: the card)

    @property
    def size(self) -> int:
        return self.ann_rows + (0 if self.bf_data is None else self.bf_data.shape[0])


def build(module, dataset=None, ann_params=None, min_ann_rows: int = 100_000,
          metric: str = "sqeuclidean", device=None) -> TieredIndex:
    """A tiered index, filled with ``dataset`` if given. Host rows go to
    ``device`` (None: the CUDA card); a tensor keeps its device."""
    t = TieredIndex(module=module, ann_params=ann_params, min_ann_rows=min_ann_rows,
                    metric=metric, device=None if device is None else torch.device(device))
    if dataset is not None:
        t = extend(t, dataset)
    return t


def _build_ann(t: TieredIndex, data) -> TieredIndex:
    t.ann_index = t.module.build(data, t.ann_params) if t.ann_params is not None \
        else t.module.build(data)
    t.ann_rows = data.shape[0]
    t.bf_data = None
    return t


def extend(t: TieredIndex, new_rows) -> TieredIndex:
    """Append rows; promotes the hot tier to ANN when min_ann_rows is reached."""
    new_rows = _on_device(new_rows, t.device)
    t.device = new_rows.device
    bf = new_rows if t.bf_data is None else torch.cat([t.bf_data, new_rows.to(t.bf_data.dtype)])
    t.bf_data = bf
    if t.ann_index is None and bf.shape[0] >= t.min_ann_rows:
        t = _build_ann(t, bf)
    return t


def compact(t: TieredIndex) -> TieredIndex:
    """Fold the hot tier into the ANN tier (tiered_index.cuh compact)."""
    if t.bf_data is None or t.bf_data.shape[0] == 0:
        return t
    if t.ann_index is None:
        return _build_ann(t, t.bf_data)
    if hasattr(t.module, "extend"):
        t.ann_index = t.module.extend(t.ann_index, t.bf_data)
        t.ann_rows += t.bf_data.shape[0]
        t.bf_data = None
        return t
    raise NotImplementedError("ANN module lacks extend(); rebuild manually")


def search(t: TieredIndex, queries, k: int, prefilter=None, ann_kw: Optional[dict] = None,
           **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fan out to both tiers, merge the top-k (tiered_index.cuh:155-183).

    Extra keyword arguments go to the ANN tier's search, merged over
    ``ann_kw``. The prefilter applies to the ANN tier only (see the module
    docstring)."""
    ann_kw = {**(ann_kw or {}), **kw}
    queries = _on_device(queries, t.device)
    parts_d, parts_i = [], []
    if t.ann_index is not None:
        d, i = t.module.search(t.ann_index, queries, k, prefilter=prefilter, **ann_kw)
        parts_d.append(d)
        parts_i.append(i)
    if t.bf_data is not None and t.bf_data.shape[0] > 0:
        bf_index = brute_force.build(t.bf_data, metric=t.metric)
        d, i = brute_force.search(bf_index, queries, min(k, t.bf_data.shape[0]), prefilter=None,
                                  fused=True)
        parts_d.append(d)
        parts_i.append(i + t.ann_rows)  # hot-tier ids follow the ANN tier's
    if not parts_d:
        raise ValueError("empty tiered index")
    if len(parts_d) == 1:
        return parts_d[0], parts_i[0]
    return merge_parts(parts_d, parts_i, k, select_min=is_min_close(t.metric))


_MODULES = ("cagra", "ivf_flat", "ivf_pq", "ivf_sq", "ivf_rabitq", "brute_force")


def _params_to_json(p):
    """JSON encoding of an IndexParams dataclass: enums as their integer,
    dtypes by name (torch or numpy), fields that are neither dropped."""
    if p is None or not dataclasses.is_dataclass(p):
        return None
    out = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if hasattr(v, "value") and isinstance(getattr(v, "value"), int):
            v = int(v)
        elif isinstance(v, torch.dtype):
            v = str(v).removeprefix("torch.")
        elif v is not None and not isinstance(v, (int, float, str, bool)):
            try:
                v = np.dtype(v).name
            except TypeError:
                continue
        out[f.name] = v
    return out


def _params_from_json(module, fields):
    """The module's IndexParams from ``_params_to_json`` fields (dtype names
    back to torch dtypes); None where the fields do not fit it."""
    if fields is None or not hasattr(module, "IndexParams"):
        return None
    kw = {name: getattr(torch, v) if isinstance(v, str) and isinstance(getattr(torch, v, None),
                                                                      torch.dtype) else v
          for name, v in fields.items()}
    try:
        return module.IndexParams(**kw)
    except TypeError:
        return None


def save(path: str, t: TieredIndex) -> None:
    """The tiered state: the ANN sub-index (``ann.npz``), the hot-tier rows
    (``bf_data.npy``) and a header (tiered_index.cuh:109 serializes the same
    state machine)."""
    has_bf = t.bf_data is not None and t.bf_data.shape[0] > 0
    ser.write_dir_header(path, "tiered_header.json", MAGIC, {
        "module": t.module.__name__.rsplit(".", 1)[-1], "min_ann_rows": int(t.min_ann_rows),
        "metric": t.metric, "ann_rows": int(t.ann_rows), "has_ann": t.ann_index is not None,
        "has_bf": has_bf, "ann_params": _params_to_json(t.ann_params)})
    if t.ann_index is not None:
        ser.save(os.path.join(path, "ann.npz"), t.ann_index)
    if has_bf:
        np.save(os.path.join(path, "bf_data.npy"), t.bf_data.cpu().numpy())


def load(path: str, device=None) -> TieredIndex:
    """Read a tiered index saved by either package's ``save``; its tensors go
    to ``device`` (None: the CUDA card)."""
    header = ser.read_dir_header(path, "tiered_header.json", MAGIC)
    mod_name = header["module"]
    if mod_name not in _MODULES:
        raise ValueError(f"unknown ANN module {mod_name!r}")
    module = importlib.import_module(f"cuvs_tpu_torch.neighbors.{mod_name}")
    t = TieredIndex(module=module, ann_params=_params_from_json(module, header.get("ann_params")),
                    min_ann_rows=header["min_ann_rows"], metric=header["metric"],
                    ann_rows=header["ann_rows"])
    if header["has_ann"]:
        t.ann_index = ser.load(os.path.join(path, "ann.npz"), device=device)
        t.device = t.ann_index.device
    if header["has_bf"]:
        t.bf_data = _on_device(np.load(os.path.join(path, "bf_data.npy")), device)
        t.device = t.bf_data.device
    if t.device is None and device is not None:
        t.device = torch.device(device)
    return t
