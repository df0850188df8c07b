"""Milliseconds a query in the engine's "replay" stage: the paths spliced
and the accept/terminate loop replayed (finish_replay_c, capacity
retries included), from the program's span over the window."""


def read(run):
    c = run["counters"]
    if not c.get("queries") or "replay_ns" not in c:
        return None
    return 1e-6 * c["replay_ns"] / c["queries"]
