"""Device kernels launched per query in the traced requests."""


def read(run):
    t = run.trace
    if not t or not t.n_queries:
        return None
    n = t.count()
    return n / t.n_queries if n else None
