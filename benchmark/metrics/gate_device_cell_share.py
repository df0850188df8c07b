"""The share of the holes' cells that the engine's gate sent to the card,
in %: device_cells over device_cells + host_cells, the program's counters
over the window (a hole's cells: its shorter length times the band)."""


def read(run):
    c = run["counters"]
    if "device_cells" not in c or "host_cells" not in c:
        return None
    total = c["device_cells"] + c["host_cells"]
    if total <= 0:
        return None
    return 100.0 * c["device_cells"] / total
