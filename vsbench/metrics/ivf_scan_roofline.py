"""The IVF-Flat scan kernels' share of their roofline, %: the least time of
the traced batches' scan work (``vsbench.roofline.ivf_flat_scan``, counted
from the problem) over the device time of the ``ivf_scan`` kernels."""


def read(run):
    t, least = run.trace, run.work.get("ivf_scan")
    seconds = t.seconds(lambda name: "ivf_scan" in name) if t else 0.0
    return 100.0 * least / seconds if seconds and least else None
