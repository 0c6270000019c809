"""Share of the traced batches' queries whose beam search ran the CAGRA beam
kernel: the ``beam_kernel_queries`` counter of the ``cagra::beam`` spans over
the ``queries`` counter of the search calls. None where the program counts
no such queries (a beam search without the kernel)."""

from vsbench import spans


def read(run):
    walked = spans.counted(run, "beam_kernel_queries", "::beam")
    queries = spans.counted(run, "queries", "::search")
    return walked / queries if walked is not None and queries else None
