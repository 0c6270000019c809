"""Tracing annotations — port of ``cuvs_tpu.utils.tracing``.

``traced(name)`` wraps a public entry point in a
``torch.profiler.record_function`` range (visible in ``torch.profiler``
traces, the NVTX-range analog) and, with ``CUVS_TPU_TRACE=1``, logs its
host wall time.
"""

from __future__ import annotations

import functools
import logging
import os
import time

import torch

logger = logging.getLogger("cuvs_tpu_torch")


def traced(name: str):
    """Decorator: record_function range + optional wall-time log."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with torch.profiler.record_function(name):
                if os.environ.get("CUVS_TPU_TRACE"):
                    t0 = time.perf_counter()
                    out = fn(*args, **kw)
                    logger.info("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)
                    return out
                return fn(*args, **kw)

        return wrapper

    return deco
