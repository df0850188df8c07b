"""Milliseconds of the ranker's device half a thousand queries: each
chunk's upload to its top K done, timed by the program with a pair of
CUDA events a chunk while the window is traced (on the CPU, the host
clock around the same ops), from its counters over the window."""


def read(run):
    c = run["counters"]
    if not c.get("queries") or "rank_device_ns" not in c:
        return None
    return 1e-3 * c["rank_device_ns"] / c["queries"]
