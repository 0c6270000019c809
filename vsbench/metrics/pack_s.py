"""Stream seconds per traced build of the packing of the sorted codes, the
serving layout and the index's assembly (``ivf_pq::pack`` spans)."""

from vsbench import spans


def read(run):
    ms = spans.stream_ms(run, "ivf_pq::pack")
    return ms / 1e3 if ms is not None else None
