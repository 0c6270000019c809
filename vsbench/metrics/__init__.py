"""One reader per metric, named as the metric: ``read(run) -> float | None``
(``run`` is a ``vsbench.harness.Run``). A reader that finds nothing to read
returns None, and the metric is left out of the line."""
