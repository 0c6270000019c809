"""Device ms per batch of every operation that is not a fused scan kernel
(coarse search, grouping, pool merge, selection, refine, copies)."""

SCANS = ("pq_scan", "ivf_scan")


def read(run):
    t = run.trace
    if not t or not t.n_requests:
        return None
    seconds = t.seconds(lambda name: not any(s in name for s in SCANS))
    return seconds / t.n_requests * 1e3 if seconds else None
