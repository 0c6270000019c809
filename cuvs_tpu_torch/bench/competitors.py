"""Competitor algorithm wrappers for the benchmark harness — port of ``cuvs_tpu.bench.competitors``.

Reference analog: cpp/bench/ann/src/{hnswlib,faiss,diskann,ggnn}/, which link
external libraries as competitor rows. None of those can be installed here,
so the CPU HNSW competitor is an independent C++ implementation of the HNSW
algorithm (``native/hnsw_baseline.cpp``, single-threaded), driven over the
same datasets and recall methodology as the port's contenders. It runs on
the host by design. The port loads it from its own host library
(``cuvs_tpu_torch.io.native``), never from the JAX package's.
"""

from __future__ import annotations

import ctypes
import time
from typing import Tuple

import numpy as np

from cuvs_tpu_torch.io import native


class HnswCpu:
    """CPU HNSW competitor (single-thread, L2/IP)."""

    def __init__(self, M: int = 16, ef_construction: int = 200,
                 metric: str = "sqeuclidean", seed: int = 0):
        self.M = M
        self.efc = ef_construction
        self.ip = metric in ("inner_product", "ip")
        self.seed = seed
        self._h = None
        self.build_seconds = None

    def build(self, dataset: np.ndarray) -> "HnswCpu":
        x = np.ascontiguousarray(dataset, np.float32)
        t0 = time.time()
        self._h = native.lib().hnswb_build(
            x.ctypes.data_as(ctypes.c_void_p), x.shape[0], x.shape[1],
            self.M, self.efc, int(self.ip), self.seed,
        )
        self.build_seconds = time.time() - t0
        return self

    def search(self, queries: np.ndarray, k: int, ef: int = 64
               ) -> Tuple[np.ndarray, np.ndarray]:
        if self._h is None:
            raise RuntimeError("HnswCpu.search before build")
        q = np.ascontiguousarray(queries, np.float32)
        nq = q.shape[0]
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        native.lib().hnswb_search(
            self._h, q.ctypes.data_as(ctypes.c_void_p), nq, k, max(ef, k),
            out_i.ctypes.data_as(ctypes.c_void_p),
            out_d.ctypes.data_as(ctypes.c_void_p),
        )
        return out_d, out_i

    def __del__(self):
        if self._h is not None:
            try:
                native.lib().hnswb_free(self._h)
            except (AttributeError, TypeError):  # module globals torn down at interpreter exit
                pass
            self._h = None
