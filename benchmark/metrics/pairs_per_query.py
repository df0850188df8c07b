"""Candidate pairs a query: the pairs the engine's rounds HSP-chained
(speculative ones included, 1, 2, 4, then 8 a job a round while the
engine has a device), over the queries searched, from the program's
counters over the window."""


def read(run):
    c = run["counters"]
    if not c.get("queries") or "pairs" not in c:
        return None
    return c["pairs"] / c["queries"]
