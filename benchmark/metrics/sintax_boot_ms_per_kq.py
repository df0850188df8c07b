"""Milliseconds a thousand queries of the SINTAX boots on the host's clock:
the span sintax_boots around the chunks' run_chunk calls (upload, kernels,
copy back), from the program's counters over the window."""


def read(run):
    c = run["counters"]
    if not c.get("sintax_queries") or "sintax_boots_ns" not in c:
        return None
    return 1e-3 * c["sintax_boots_ns"] / c["sintax_queries"]
