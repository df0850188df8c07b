"""Queries completed in the window over the window's seconds: all the work
over all the time."""


def read(run):
    if not run["requests"]:
        return None
    return sum(r["queries"] for r in run["requests"] if "error" not in r) \
        / run["window_s"]
