"""Adapters from a configuration to the port's entry points, one file per
index type, found by the configuration's ``algo``. Each gives ``build``,
``searcher`` (``search(q)`` returns the answer's distances and ids, and where
the index re-ranks a scan's candidates, the candidates' scores and ids after
them), ``work`` (the scan's least seconds for a batch, from
``vsbench.roofline``), ``quantizer`` where the candidates are judged, and
``state`` where a build cell judges the index."""
