"""Comparison helper for the port's parity tests (numpy only)."""

import numpy as np


def ids_match_modulo_ties(ids_a, ids_b, dists, rtol=1e-5, atol=1e-4):
    """Assert two [nq, k] id lists agree wherever the distance at that rank is
    not tied, within rtol/atol, with a neighbouring rank. The last rank may
    tie a candidate that did not make the cut, so it is not compared."""
    ids_a, ids_b, dists = np.asarray(ids_a), np.asarray(ids_b), np.asarray(dists, np.float64)
    tol = atol + rtol * np.abs(dists)
    close = np.abs(np.diff(dists, axis=1)) <= tol[:, 1:]
    tied = np.zeros(dists.shape, bool)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    tied[:, -1] = True
    assert np.all((ids_a == ids_b) | tied)
