"""Stream seconds per traced build of the rows' lists, the rotation, the
residuals and the list sort (``ivf_pq::assign`` spans)."""

from vsbench import spans


def read(run):
    ms = spans.stream_ms(run, "ivf_pq::assign")
    return ms / 1e3 if ms is not None else None
