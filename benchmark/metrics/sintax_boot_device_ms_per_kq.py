"""Milliseconds a thousand queries of the SINTAX boot step on the card:
each chunk's kernels between a pair of CUDA events, made by the program
while the window is traced (on the CPU, the host clock around the same
step), from its counters over the window."""


def read(run):
    c = run["counters"]
    if not c.get("sintax_queries") or "sintax_boot_device_ns" not in c:
        return None
    return 1e-3 * c["sintax_boot_device_ns"] / c["sintax_queries"]
