"""Milliseconds a query of the hole DP on the card's stream:
TorchWaveAligner.align's holedp_device, two CUDA events a launch around
wavefront_fwd and wavefront_trace (made while the profiler records), over
the window."""


def read(run):
    c = run["counters"]
    if not c.get("queries") or "holedp_device_ns" not in c:
        return None
    return 1e-6 * c["holedp_device_ns"] / c["queries"]
