"""Milliseconds a query of the SINTAX classifier's tie-break draws (the
global generator, one draw a boot a classified strand, on the host): the
span sintax_draws, inside sintax_prepare, from the program's counters over
the window."""


def read(run):
    c = run["counters"]
    if not c.get("sintax_queries") or "sintax_draws_ns" not in c:
        return None
    return 1e-6 * c["sintax_draws_ns"] / c["sintax_queries"]
