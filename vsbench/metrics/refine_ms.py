"""Stream ms per traced request of the exact re-rank (``refine::refine``
spans); the reader of every ``refine_ms.<mix>``."""

from vsbench import spans


def read(run):
    return spans.stream_ms(run, "refine::refine")
