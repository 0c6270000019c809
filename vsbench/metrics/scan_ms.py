"""Stream ms per traced request of the scan kernel's call (``ivf::scan`` spans;
cluster-major: the whole chunk loop)."""

from vsbench import spans


def read(run):
    return spans.stream_ms(run, "ivf::scan")
