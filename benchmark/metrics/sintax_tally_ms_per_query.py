"""Milliseconds a query of the SINTAX classifier's host tally: the span
sintax_tally (each strand's winners counted by taxonomy, the strand vote,
the confidences and the tabbed rows), from the program's counters over the
window."""


def read(run):
    c = run["counters"]
    if not c.get("sintax_queries") or "sintax_tally_ns" not in c:
        return None
    return 1e-6 * c["sintax_tally_ns"] / c["sintax_queries"]
