"""95th percentile of every request's time from the call to its result,
synchronised with the device, in ms on the host clock."""

import statistics


def read(run):
    lat = run.window.latency_s
    if len(lat) < 20 or not run.window.answers:
        return None
    return statistics.quantiles(lat, n=100)[94] * 1e3
