"""The 95th percentile of every request's latency in the window (a
request: one query file through the engine, from the call to its
return)."""

import statistics


def read(run):
    lat = [r["latency_s"] for r in run["requests"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
