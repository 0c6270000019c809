"""Dataset files and the host library — port of ``cuvs_tpu.io.native``.

Formats (big-ann-benchmarks layout, as consumed by cuvs_bench, blob.hpp):
``.fbin`` (float32), ``.ibin`` (int32), ``.u8bin`` (uint8), ``.i8bin``
(int8): [int32 n_rows][int32 dim][payload].

The port's host library holds the memory-mapped reader and writer
(``native/dataset_io.cpp``), the batch queue of dynamic batching
(``native/batch_queue.cpp``) and the CPU HNSW competitor of the bench harness
(``native/hnsw_baseline.cpp``): the three sources ``native/Makefile`` links
into one library. It is built at its first use with the C++
compiler (``c++``, the flags of ``native/Makefile``) into
``cuvs_tpu_torch/_build/``, named by a hash of the sources and flags, and
renamed into place so concurrent builds never leave a partial file. Nothing
here builds at import time. A failed build raises: there is no numpy
fallback, and the JAX package's own library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE = _PKG.parent / "native"
SOURCES = ("dataset_io.cpp", "batch_queue.cpp", "hnsw_baseline.cpp")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_DTYPES = {
    ".fbin": np.float32,
    ".ibin": np.int32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
}

_P, _I32, _I64, _INT = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int
# restype, argtypes of each C entry point
_SIGNATURES = {
    "cuvs_tpu_open_bin": (_P, [ctypes.c_char_p, _I32]),
    "cuvs_tpu_bin_rows": (_I32, [_P]),
    "cuvs_tpu_bin_dim": (_I32, [_P]),
    "cuvs_tpu_bin_data": (_P, [_P]),
    "cuvs_tpu_close_bin": (None, [_P]),
    "cuvs_tpu_read_rows": (_INT, [_P, _I64, _I64, _P, _INT]),
    "cuvs_tpu_write_bin": (_INT, [ctypes.c_char_p, _P, _I32, _I32, _I32]),
    "cuvs_tpu_queue_create": (_P, [_I64, _I64]),
    "cuvs_tpu_queue_destroy": (None, [_P]),
    "cuvs_tpu_queue_close": (None, [_P]),
    "cuvs_tpu_queue_push": (_I64, [_P, _P, _I64, _I64]),
    "cuvs_tpu_queue_pop_batch": (_I64, [_P, _P, _P, _I64, _I64]),
    "cuvs_tpu_queue_size": (_I64, [_P]),
    "hnswb_build": (_P, [_P, _I64, _INT, _INT, _INT, _INT, ctypes.c_uint64]),
    "hnswb_search": (None, [_P, _P, _I64, _INT, _INT, _P, _P]),
    "hnswb_free": (None, [_P]),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    return BUILD_DIR / f"libcuvs_tpu_torch_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host library if the one for the current sources is missing."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "c++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX or put c++ on PATH): the host "
                           "library is built from native/*.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, out.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", so, *(str(NATIVE / s) for s in SOURCES)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"c++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(so, out)
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    so = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return so


def native_available() -> bool:
    """Whether the host library builds and loads here."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


def _dtype_for(path: str):
    for ext, dt in _DTYPES.items():
        if path.endswith(ext):
            return np.dtype(dt)
    raise ValueError(f"unknown dataset extension: {path}")


class BinDataset:
    """Memory-mapped dataset with batched row reads."""

    def __init__(self, path: str):
        self.path = path
        self.dtype = _dtype_for(path)
        self._lib = lib()
        self._h = self._lib.cuvs_tpu_open_bin(path.encode(), self.dtype.itemsize)
        if not self._h:
            raise OSError(f"failed to open {path}")
        self.n_rows = self._lib.cuvs_tpu_bin_rows(self._h)
        self.dim = self._lib.cuvs_tpu_bin_dim(self._h)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.dim)

    def read(self, start: int = 0, count: Optional[int] = None, n_threads: int = 4) -> np.ndarray:
        """Copy rows [start, start+count) into a fresh array."""
        if count is None:
            count = self.n_rows - start
        if start < 0 or start + count > self.n_rows:
            raise IndexError("row range out of bounds")
        if self._h is None:
            raise ValueError(f"{self.path} is closed")
        out = np.empty((count, self.dim), self.dtype)
        rc = self._lib.cuvs_tpu_read_rows(self._h, start, count,
                                          out.ctypes.data_as(ctypes.c_void_p), n_threads)
        if rc != 0:
            raise OSError("native read failed")
        return out

    def batches(self, batch_size: int):
        for s in range(0, self.n_rows, batch_size):
            yield self.read(s, min(batch_size, self.n_rows - s))

    def close(self):
        if self._h is not None:
            self._lib.cuvs_tpu_close_bin(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def load_bin(path: str) -> np.ndarray:
    """Read a whole .bin dataset into memory."""
    with BinDataset(path) as d:
        return d.read()


def write_bin(path: str, array) -> None:
    """Write a big-ann .bin file (dtype from the extension)."""
    array = np.ascontiguousarray(array, _dtype_for(path))
    rc = lib().cuvs_tpu_write_bin(path.encode(), array.ctypes.data_as(ctypes.c_void_p),
                                  array.shape[0], array.shape[1], array.dtype.itemsize)
    if rc != 0:
        raise OSError(f"failed to write {path}")
