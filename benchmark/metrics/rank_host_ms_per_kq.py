"""Milliseconds of the ranker's host half a thousand queries: the CSR
ranker's spans rank_prepare (each query's words cut into padded chunks)
and rank_finish (the ranked lists cut, and the host's ranking of the jobs
the card left uncertain), from the program's counters over the window."""


def read(run):
    c = run["counters"]
    if not c.get("queries") or "rank_prepare_ns" not in c:
        return None
    return 1e-3 * (c["rank_prepare_ns"] + c.get("rank_finish_ns", 0)) \
        / c["queries"]
