"""Stream ms per traced request of the graph search's beam loops
(``cagra::beam`` spans, one a chunk); the reader of every ``beam_ms.<mix>``."""

from vsbench import spans


def read(run):
    return spans.stream_ms(run, "cagra::beam")
