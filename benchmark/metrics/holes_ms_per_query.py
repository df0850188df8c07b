"""Milliseconds a query in the engine's "holes" stage: the rounds' holes
aligned by BatchEngine._align_holes, on the card or the host C kernel
(the gate's decision included), from the program's span over the
window."""


def read(run):
    c = run["counters"]
    if not c.get("queries") or "holes_ns" not in c:
        return None
    return 1e-6 * c["holes_ns"] / c["queries"]
