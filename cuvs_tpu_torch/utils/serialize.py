"""Index files — port of ``cuvs_tpu.utils.serialize``, in the same format.

One ``.npz`` file: a ``__header__`` entry holding JSON (the magic
``cuvs_tpu.index``, the version, the kind, the static fields and the sorted
array keys) and the arrays as ``a0 .. aN`` in that order, under the
reference's tree-path keys (``.centers``, ``.lists.offsets``, the packed
CAGRA's ``.child_vecs[i]`` pieces, ...; a None field has no key). No pickle: ``load`` checks the header before it reads an
array and rebuilds the index through the ``interop`` constructors, which also
take the reference's padded serving arrays, so each package loads the
other's files.

An index of several parts (the multi-device, offloaded and tiered indexes)
is a directory: a JSON header with its own magic (``cuvs_tpu.mg_index``,
``cuvs_tpu.offload_index``, ``cuvs_tpu.tiered_index``) and version, and one
file per part (``shard_{s}.npz``, ``ann.npz``) in the format above.

Code words are written as uint32 and read back as int32 with the same bits.
bfloat16 arrays are written as 2-byte records (what numpy makes of the
reference's ``ml_dtypes`` bfloat16) and read back bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from cuvs_tpu_torch.neighbors.ivf_common import SortedLists

MAGIC = "cuvs_tpu.index"
VERSION = 1

# the static (non-array) fields of each kind, as the reference's header names them
_STATICS = {
    "brute_force": ("metric", "metric_arg"),
    "ivf_flat": ("metric", "window", "n_rows", "adaptive_centers"),
    "ivf_pq": ("metric", "window", "n_rows", "pq_bits", "codebook_gen", "pq_dim_static"),
    "ivf_sq": ("metric", "window", "n_rows"),
    "ivf_rabitq": ("metric", "window", "n_rows", "bits_per_dim"),
    "cagra": ("metric",),
    "cagra.CompressedIndex": ("metric",),
    "cagra.PackedIndex": ("metric",),
}
_WORDS = (".sorted_codes", ".sorted_codes_t")  # int32 code words of these two kinds
_WORD_KINDS = ("ivf_pq", "ivf_rabitq")


def kind_of(index) -> str:
    kind = type(index).__module__.rsplit(".", 1)[-1]
    cls = type(index).__name__
    return kind if cls == "Index" else f"{kind}.{cls}"


def _numpy(t: torch.Tensor, words: bool) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    a = t.numpy()
    return a.view(np.uint32) if words else a


def _arrays_of(index, kind: str) -> Dict[str, np.ndarray]:
    words = _WORDS if kind in _WORD_KINDS else ()
    out = {}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        key = "." + f.name
        if isinstance(v, SortedLists):
            for name, arr in v._asdict().items():
                out[f"{key}.{name}"] = _numpy(arr, False)
        elif isinstance(v, torch.Tensor):
            out[key] = _numpy(v, key in words)
        elif isinstance(v, tuple):  # the packed CAGRA's child_vecs pieces
            for i, arr in enumerate(v):
                out[f"{key}[{i}]"] = _numpy(arr, False)
    return out


def save(path: str, index: Any) -> None:
    """Write an index to ``path`` (an npz container)."""
    kind = kind_of(index)
    if kind not in _STATICS:
        raise ValueError(f"cannot save an index of kind {kind!r}")
    statics = {}
    for name in _STATICS[kind]:
        v = getattr(index, name)
        statics[name] = int(v) if hasattr(v, "value") else v  # IntEnum metric
    arrays = _arrays_of(index, kind)
    header = {"magic": MAGIC, "version": VERSION, "kind": kind, "statics": statics,
              "arrays": sorted(arrays)}
    payload = {f"a{i}": arr for i, (_, arr) in enumerate(sorted(arrays.items()))}
    with open(path, "wb") as f:
        np.savez(f, __header__=np.frombuffer(json.dumps(header).encode(), np.uint8), **payload)


def _lists(a, prefix=".lists"):
    return [a[f"{prefix}.{name}"] for name in ("offsets", "sizes", "ids", "labels")]


def _build(kind: str, a: Dict[str, np.ndarray], s: Dict[str, Any], device):
    from cuvs_tpu_torch import interop

    if kind == "brute_force":
        return interop.brute_force_index_from_numpy(
            a[".dataset"], a.get(".norms"), a.get(".q_scale"), s["metric"], device=device,
            metric_arg=s.get("metric_arg", 2.0))
    if kind == "ivf_flat":
        return interop.ivf_flat_index_from_numpy(
            a[".centers"], a[".center_norms"], a[".sorted_data"], a[".sorted_norms"],
            *_lists(a), a.get(".q_scale"), s["metric"], s["window"], s["n_rows"], device=device,
            adaptive_centers=s.get("adaptive_centers", False))
    if kind == "ivf_pq":
        return interop.ivf_pq_index_from_numpy(
            a[".centers"], a[".center_norms"], a[".centers_rot"], a[".rotation"],
            a[".pq_centers"], a[".sorted_codes"], *_lists(a), s["metric"], s["window"],
            s["n_rows"], s["pq_bits"], a.get(".sorted_codes_t"), a.get(".sorted_code_norms"),
            device=device, codebook_gen=s.get("codebook_gen", "per_subspace"),
            pq_dim=s.get("pq_dim_static", 0))
    if kind == "ivf_sq":
        return interop.ivf_sq_index_from_numpy(
            a[".centers"], a[".center_norms"], a[".sorted_codes"], a[".sorted_norms"],
            a[".q_min"], a[".q_max"], *_lists(a), s["metric"], s["window"], s["n_rows"],
            device=device)
    if kind == "ivf_rabitq":
        return interop.ivf_rabitq_index_from_numpy(
            a[".centers"], a[".center_norms"], a[".rotation"], a[".centers_rot"],
            a[".sorted_codes"], a[".sorted_fadd"], a[".sorted_frescale"], *_lists(a),
            s["metric"], s["window"], s["n_rows"], s["bits_per_dim"], a.get(".sorted_codes_t"),
            device=device)
    if kind == "cagra":
        return interop.cagra_index_from_numpy(a[".dataset"], a[".dataset_norms"], a[".graph"],
                                              s["metric"], device=device)
    if kind == "cagra.CompressedIndex":
        return interop.cagra_compressed_index_from_numpy(
            a[".vq_centers"], a[".vq_codes"], a[".pq_codes"], a[".pq_codebooks"],
            a[".dataset_norms"], a[".graph"], s["metric"], device=device)
    if kind == "cagra.PackedIndex":
        # pieces are keyed .child_vecs[i]; a single .child_vecs key is the
        # reference's older one-array format
        if ".child_vecs" in a:
            pieces = [a[".child_vecs"]]
        else:
            keys = sorted((k for k in a if k.startswith(".child_vecs[")),
                          key=lambda k: int(k[len(".child_vecs["):-1]))
            pieces = [a[k] for k in keys]
        return interop.cagra_packed_index_from_numpy(
            a[".graph"], pieces, a[".child_norms"], a[".dataset_int8"], a[".dataset_norms"],
            a[".scale"], s["metric"], device=device)
    raise ValueError(f"unknown index kind {kind!r}")


def load(path: str, expected_kind: str = None, device=None) -> Any:
    """Read an index, checking magic, version and kind first. Its arrays go
    to ``device`` (None: the CUDA card)."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"].tobytes()).decode())
        if header.get("magic") != MAGIC:
            raise ValueError("not a cuvs_tpu index file (bad magic)")
        if header.get("version", -1) > VERSION:
            raise ValueError(f"index file version {header['version']} newer than supported "
                             f"{VERSION}")
        kind = header["kind"]
        if expected_kind is not None and kind != expected_kind:
            raise ValueError(f"expected {expected_kind} index, file holds {kind}")
        if kind not in _STATICS:
            raise ValueError(f"unknown index kind {kind!r}")
        arrays = {name: z[f"a{i}"] for i, name in enumerate(header["arrays"])}
    return _build(kind, arrays, header["statics"], device)


def write_dir_header(path: str, name: str, magic: str, fields: Dict[str, Any]) -> None:
    """Create the directory ``path`` and write its JSON header ``name``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "w") as f:
        json.dump({"magic": magic, "version": VERSION, **fields}, f)


def read_dir_header(path: str, name: str, magic: str) -> Dict[str, Any]:
    """A directory's JSON header, after checking its magic and version."""
    with open(os.path.join(path, name)) as f:
        header = json.load(f)
    if header.get("magic") != magic:
        raise ValueError(f"not a {magic} directory (bad magic)")
    if header.get("version", -1) > VERSION:
        raise ValueError(f"{magic} version {header['version']} newer than supported {VERSION}")
    return header


def shard_path(path: str, s: int) -> str:
    """The file of part ``s`` of a sharded index directory."""
    return os.path.join(path, f"shard_{s}.npz")
