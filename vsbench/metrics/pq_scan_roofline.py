"""The PQ scan kernels' share of their roofline, %: the least time of the
traced batches' scan work (``vsbench.roofline.pq_scan``, counted from the
problem) over the device time of the ``pq_scan`` kernels in the trace."""


def read(run):
    t, least = run.trace, run.work.get("pq_scan")
    seconds = t.seconds(lambda name: "pq_scan" in name) if t else 0.0
    return 100.0 * least / seconds if seconds and least else None
