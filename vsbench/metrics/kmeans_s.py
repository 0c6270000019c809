"""Stream seconds per traced build of the balanced k-means
(``kmeans_balanced::fit`` spans)."""

from vsbench import spans


def read(run):
    ms = spans.stream_ms(run, "kmeans_balanced::fit")
    return ms / 1e3 if ms is not None else None
