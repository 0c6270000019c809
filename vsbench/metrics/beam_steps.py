"""Beam steps per traced request: the ``beam_steps`` counter of the search
calls (the steps their loops ran, summed over the chunks) over the traced
requests; the reader of every ``beam_steps.<mix>``. None where the program
counts no steps."""

from vsbench import spans


def read(run):
    steps = spans.counted(run, "beam_steps", "::search")
    return steps / run.trace.n_requests if steps is not None else None
