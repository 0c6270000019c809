"""Hits among the 10 returned ids in the reference's exact 10 nearest, over
every query answered in the window (a build cell: over a search of the last
index built). The reader of every ``recall_at_10.<mix>`` too."""


def read(run):
    n = run.numbers.get("recall_at_10")
    return n.value if n is not None else None
