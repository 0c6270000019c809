"""The port's C library: the C ABI of ``capi/`` over ``cuvs_tpu_torch``.

``capi/cuvs_tpu_c.cpp`` embeds CPython and imports its bridge module by name.
The port compiles that file unchanged with
``-DPyImport_ImportModule=cuvs_tpu_torch_import`` and links it with
``csrc/capi_import.cpp``, whose ``cuvs_tpu_torch_import`` answers the import
of ``cuvs_tpu.capi_bridge`` with ``cuvs_tpu_torch.capi_bridge``. The library
is built at its first use with the C++ compiler (``c++``; Python's headers
and its ``--embed`` link flags from ``sysconfig``) into
``cuvs_tpu_torch/_build/libcuvs_tpu_torch_c_<hash>.so``, named by a hash of
the sources and flags and renamed into place, so concurrent builds never
leave a partial file. ``capi/libcuvs_tpu_c.so`` (``make -C capi``) is the
JAX package's library and is never used or written here.

A program that calls the C ABI links the library (``build_program``); it runs
in ``program_env()``, where the embedded interpreter finds this repository.
``csrc/capi_card_check.c`` is such a program: an exact search through the
ABI on the CUDA card.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path
from typing import List, Sequence

_PKG = Path(__file__).resolve().parent
CAPI = _PKG.parent / "capi"
BUILD_DIR = _PKG / "_build"
SOURCES = (CAPI / "cuvs_tpu_c.cpp", _PKG / "csrc" / "capi_import.cpp")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
REDIRECT = "-DPyImport_ImportModule=cuvs_tpu_torch_import"


def python_flags() -> tuple:
    """(compile flags, link flags) of an embedded CPython, what
    ``python3-config --includes`` and ``--ldflags --embed`` print."""
    paths = sysconfig.get_paths()
    includes = [f"-I{d}" for d in dict.fromkeys((paths["include"], paths["platinclude"]))]
    var = sysconfig.get_config_var
    libdir = var("LIBDIR")
    ldflags = [f"-L{libdir}", f"-lpython{var('LDVERSION')}", *(var("LIBS") or "").split(),
               *(var("SYSLIBS") or "").split(), f"-Wl,-rpath,{libdir}"]
    return includes, ldflags


def _tool(env: str, default: str) -> str:
    path = shutil.which(os.environ.get(env, default))
    if path is None:
        raise RuntimeError(f"no compiler found (set {env} or put {default} on PATH)")
    return path


def _run(cmd: Sequence[str]) -> None:
    proc = subprocess.run(list(cmd), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")


def library_path() -> Path:
    includes, ldflags = python_flags()
    h = hashlib.sha256(" ".join(CXX_FLAGS + [REDIRECT] + includes + ldflags).encode())
    for src in SOURCES + (CAPI / "cuvs_tpu.h", CAPI / "dlpack.h"):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcuvs_tpu_torch_c_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the C library if the one for the current sources is missing."""
    out = library_path()
    if out.exists():
        return out
    cxx = _tool("CXX", "c++")
    includes, ldflags = python_flags()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs: List[str] = []
        for src, extra in zip(SOURCES, ([REDIRECT], [])):
            obj = os.path.join(tmp, src.stem + ".o")
            _run([cxx, *CXX_FLAGS, *extra, *includes, f"-I{CAPI}", "-c", str(src), "-o", obj])
            objs.append(obj)
        so = os.path.join(tmp, out.name)
        _run([cxx, "-shared", "-o", so, *objs, *ldflags])
        os.replace(so, out)
    return out


def build_program(source, out) -> str:
    """Compile a C program that includes ``cuvs_tpu.h`` against the port's
    C library (``cc``; the library is linked by its absolute path)."""
    lib = build()
    _run([_tool("CC", "cc"), "-O2", f"-I{CAPI}", "-o", str(out), str(source), str(lib),
          f"-Wl,-rpath,{lib.parent}"])
    return str(out)


def program_env(*paths) -> dict:
    """The environment of a program that calls the C ABI: ``PYTHONPATH``
    holds ``paths``, this repository and the running interpreter's import
    path, so that the embedded interpreter finds this package and what it
    imports."""
    entries = [str(p) for p in paths] + [str(_PKG.parent)] + [p for p in sys.path if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(dict.fromkeys(entries)))
