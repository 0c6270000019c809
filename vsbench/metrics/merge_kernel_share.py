"""Share of the traced batches' queries whose pool merge ran the pool top-k
kernel: the ``merge_kernel_queries`` counter of the ``ivf::merge`` spans
over the ``queries`` counter of the search calls. None where the program
counts no such queries (a merge without the kernel)."""

from vsbench import spans


def read(run):
    merged = spans.counted(run, "merge_kernel_queries", "ivf::merge")
    queries = spans.counted(run, "queries", "::search")
    return merged / queries if merged is not None and queries else None
