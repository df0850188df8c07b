"""Milliseconds a query of the window's requests spent outside the
ranker: a request's wall time less the wrapped ranker's, summed, over the
queries."""


def read(run):
    reqs = run["requests"]
    n = sum(r["queries"] for r in reqs)
    if not n:
        return None
    return 1e3 * sum(r["latency_s"] - r["rank_s"] for r in reqs) / n
