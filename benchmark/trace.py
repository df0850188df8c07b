"""What the benchmark reads from a torch.profiler trace of the window:
the device's busy time, its busiest operations, and where it sat idle.

The harness marks the window ("bench.window") and each request
("bench.request") with record_function, and a command module marks its
calls into the program's layers ("bench.<layer>", span()).  The idle
time is split by what the host was doing: inside a layer's call, in the
rest of a request, or between requests.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import nullcontext

WINDOW, REQUEST = "bench.window", "bench.request"


def span(on: bool, name: str):
    """A range of the trace named `name` when tracing, else nothing."""
    if not on:
        return nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(ranges):
    """f(t): how long the sorted, disjoint ranges cover before t."""
    starts = [s for s, _ in ranges]
    acc = [0]
    for s, e in ranges:
        acc.append(acc[-1] + e - s)

    def f(t):
        k = bisect.bisect_right(starts, t) - 1
        if k < 0:
            return 0
        return acc[k] + min(t, ranges[k][1]) - ranges[k][0]
    return f


def summarize(prof) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of the window."""
    from torch.autograd import DeviceType
    ranges = defaultdict(list)
    device = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("bench."):
            # the profiler also copies each range onto the device's
            # timeline: that copy is no device work
            if e.device_type() != DeviceType.CUDA:
                ranges[name].append((e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
        elif e.device_type() == DeviceType.CUDA:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name))
    if not ranges[WINDOW]:
        raise RuntimeError("the trace holds no bench.window range")
    ws, we = ranges[WINDOW][0]
    inwin = [(max(s, ws), min(e, we), n) for s, e, n in device
             if e > ws and s < we]
    busy = _union([(s, e) for s, e, _ in inwin])
    by_name = defaultdict(float)
    for s, e, n in inwin:
        by_name[n] += (e - s) / 1e9
    layers = sorted(k for k in ranges if k not in (WINDOW, REQUEST))
    cov = {k: _covered(_union(ranges[k])) for k in layers + [REQUEST]}
    gaps = defaultdict(float)
    last = ws
    for s, e in busy + [[we, we]]:
        if s > last:
            part = {k: cov[k](s) - cov[k](last) for k in cov}
            for k in layers:
                gaps[k[len("bench."):]] += part[k] / 1e9
            gaps["rest of a request"] += (part[REQUEST] - sum(
                part[k] for k in layers)) / 1e9
            gaps["between requests"] += (s - last - part[REQUEST]) / 1e9
        last = max(last, e)
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (we - ws) / 1e9,
            "device_ops": [[n, t] for n, t in top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items() if v > 0),
                                key=lambda x: -x[1])[:10]}
