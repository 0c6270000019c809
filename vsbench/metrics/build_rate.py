"""Rows indexed by the whole builds of the window over the window's host time
(the builds run back to back; the last one finishes)."""


def read(run):
    w = run.window
    if not w.rows_per_build or not w.n_requests:
        return None
    return w.n_requests * w.rows_per_build / w.elapsed_s
