"""Seconds from the start of the run to the window: the data made on the
card, the index built (the kernels compiled in a checkout's first run) and
the cell's shapes warmed up."""


def read(run):
    return run.setup_s
