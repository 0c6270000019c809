"""Stream ms per traced request of the coarse search (``ivf::coarse_search``
spans: the centers' product and the probes' selection)."""

from vsbench import spans


def read(run):
    return spans.stream_ms(run, "ivf::coarse_search")
