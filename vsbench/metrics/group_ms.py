"""Stream ms per traced request of the grouping of (query, probe) pairs into
tiles and the scan's operands (``ivf::group`` spans)."""

from vsbench import spans


def read(run):
    return spans.stream_ms(run, "ivf::group")
