"""Candidates the pool merge sorts a query: the ``merge_rows`` counter of
the ``ivf::merge`` spans (queries x probes x cap x 128 in the fused scans)
over the ``queries`` counter of the search calls."""

from vsbench import spans


def read(run):
    rows = spans.counted(run, "merge_rows", "ivf::merge")
    queries = spans.counted(run, "queries", "::search")
    return rows / queries if rows is not None and queries else None
