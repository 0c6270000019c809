"""Stream ms per traced request of the pool merge: the per-probe terms, the
cross-probe top-k and the ids' recovery (``ivf::merge`` spans)."""

from vsbench import spans


def read(run):
    return spans.stream_ms(run, "ivf::merge")
