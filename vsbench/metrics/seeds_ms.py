"""Stream ms per traced request of the graph search's entry points: their
host draw and copy to the device (``cagra::seeds`` spans, one a chunk); the
reader of every ``seeds_ms.<mix>``."""

from vsbench import spans


def read(run):
    return spans.stream_ms(run, "cagra::seeds")
