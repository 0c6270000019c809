"""Stream ms per traced request of the query-major probe loop
(``ivf::query_major`` spans)."""

from vsbench import spans


def read(run):
    return spans.stream_ms(run, "ivf::query_major")
