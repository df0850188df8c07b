"""Milliseconds a query in the engine's "chain" stage: the candidate pairs
HSP-chained (chain_batch_c, capacity retries included), from the
program's span over the window."""


def read(run):
    c = run["counters"]
    if not c.get("queries") or "chain_ns" not in c:
        return None
    return 1e-6 * c["chain_ns"] / c["queries"]
