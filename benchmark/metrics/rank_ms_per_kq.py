"""Milliseconds of the ranker a thousand queries: the wall time of the
rank override the harness hands to run_file (it ends with the lists
copied back, so synchronized)."""


def read(run):
    reqs = run["requests"]
    if not any(r["ranks"] is not None for r in reqs):
        return None
    n = sum(r["queries"] for r in reqs)
    return 1e6 * sum(r["rank_s"] for r in reqs) / n
