"""Shared tiny shapes of the benchmark's CPU tests."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every configuration cut to a size the CPU runs in a second or two
SHRINK = {"data": {"n_rows": 4000, "n_queries": 64}, "index": {"n_lists": 16},
          "search": {"n_probes": 16}}
CELLS = ["ivfpq-sift1m-b10k", "ivfflat-deep10m-b10k", "ivfpq-sift1m-q1", "ivfpq-sift1m-build"]


@pytest.fixture
def shrink():
    return SHRINK
