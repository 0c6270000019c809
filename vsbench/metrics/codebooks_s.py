"""Stream seconds per traced build of the codebooks' EM with its draws and
inputs (``ivf_pq::codebooks`` spans)."""

from vsbench import spans


def read(run):
    ms = spans.stream_ms(run, "ivf_pq::codebooks")
    return ms / 1e3 if ms is not None else None
