"""Stream seconds per traced build of the rows' encoding (``ivf_pq::encode``
spans)."""

from vsbench import spans


def read(run):
    ms = spans.stream_ms(run, "ivf_pq::encode")
    return ms / 1e3 if ms is not None else None
