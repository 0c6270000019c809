"""Queries answered in the window over the window's host time, which ends in a
device synchronise."""


def read(run):
    w = run.window
    return w.n_queries / w.elapsed_s if w.n_queries and w.answers else None
