"""Build and load the port's CUDA kernels (``cuvs_tpu_torch/csrc``).

The kernels have a plain C interface and are bound with ``ctypes``: at the
first launch ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one
process per source, all at once, and links the objects into one shared
library under ``cuvs_tpu_torch/_build/``, named by a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time, so the package imports on machines without
a GPU or a CUDA toolkit.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# element-type codes of the C entry points (csrc/dtype.cuh DType)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each C entry point (pointers and the stream as void*, ints as int)
_SIGNATURES = {
    "cuvs_bf_topk_exact": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "cuvs_bf_topk_approx": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "cuvs_ivf_scan": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                      _P, _P],
    "cuvs_ivf_scan_attributes": [_I, _I, _I, _I, _I, _I, _P],
    "cuvs_pq_scan": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "cuvs_pq_scan_attributes": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
# seconds of each source's nvcc in the last build of this process (build())
NVCC_SECONDS: dict = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcuvs_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for the current sources is missing.

    The library is built in a temporary directory and renamed into place, so
    a concurrent or interrupted build never leaves a partial file behind."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))

        def compile_one(src):
            t0 = time.time()
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                                   os.path.join(tmp, src.stem + ".o"), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            NVCC_SECONDS[src.name] = time.time() - t0
            return proc

        with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:  # every source at once
            procs = list(zip(srcs, pool.map(compile_one, srcs)))
        failed = [f"{src.name} ({proc.returncode}):\n{proc.stdout}" for src, proc in procs
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        so = os.path.join(tmp, out.name)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                               *(os.path.join(tmp, src.stem + ".o") for src, _ in procs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(so, out)
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
