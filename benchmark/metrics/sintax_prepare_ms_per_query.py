"""Milliseconds a query of the SINTAX classifier's preparation of its
windows' boots: the span sintax_prepare (each strand's unique words and
picks a boot, the tie-break draws, the chunks' host arrays), from the
program's counters over the window."""


def read(run):
    c = run["counters"]
    if not c.get("sintax_queries") or "sintax_prepare_ns" not in c:
        return None
    return 1e-6 * c["sintax_prepare_ns"] / c["sintax_queries"]
