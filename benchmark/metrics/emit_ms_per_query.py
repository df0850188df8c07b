"""Milliseconds a query in the engine's "emit" stage: the hits written out
(the blast6 formatter), from the program's span over the window."""


def read(run):
    c = run["counters"]
    if not c.get("queries") or "emit_ns" not in c:
        return None
    return 1e-6 * c["emit_ns"] / c["queries"]
