"""Stage spans, counters and the device timer of the port.

A span adds its duration on the host clock (time.perf_counter_ns) to
stats[f"{name}_ns"] and one to stats[f"{name}_n"], always: the stats are
a plain dict of ints that its owner keeps (BatchEngine.dev_stats, a
ranker's stats) and that USEARCH_DEVICE_STATS and the benchmark read.
While torch.profiler records, the span is also a range of the trace,
"usearch.<name>", on the clock of the card's kernels and nested under
the ranges open around it; the caller asks `profiling()` once a run and
passes the answer, so a span never asks.

DeviceTimer times work queued on a device: on a CUDA device by a pair
of CUDA events, read once the host has waited for the work anyway; on
the CPU, whose ops run as they are called, by the host clock.

This module imports no torch: the CLI's host path runs without it.
"""

from __future__ import annotations

import sys
import time
from typing import Optional


def profiling() -> bool:
    """Whether torch.profiler records in this process now (False where
    torch was never imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and bool(torch.autograd._profiler_enabled())


def add(stats: dict, key: str, n: int) -> None:
    """Count n more under key."""
    stats[key] = stats.get(key, 0) + n


def merge(dst: dict, src: dict) -> None:
    """Add src's counts into dst."""
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v


class span:
    """with span(stats, name, trace, seq): the block's time and count in
    stats; with trace, also the profiler range "usearch.<name>", whose
    args are the request's sequence number seq."""

    __slots__ = ("stats", "name", "rf", "t0")

    def __init__(self, stats: dict, name: str, trace: bool = False,
                 seq: Optional[int] = None) -> None:
        self.stats = stats
        self.name = name
        self.rf = None
        if trace:
            from torch.autograd import profiler
            self.rf = profiler.record_function(
                "usearch." + name, None if seq is None else str(seq))

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter_ns() - self.t0
        st, k = self.stats, self.name
        st[k + "_ns"] = st.get(k + "_ns", 0) + dt
        st[k + "_n"] = st.get(k + "_n", 0) + 1
        if self.rf is not None:
            self.rf.__exit__(*exc)


class DeviceTimer:
    """Nanoseconds of the work queued on `device` between start() and
    stop(), read by ns() after the host has synchronised with it (a copy
    back).  On a CUDA device it makes its two events only where `on`;
    otherwise ns() is None."""

    def __init__(self, device, on: bool = True) -> None:
        self.cuda = device.type == "cuda"
        self.on = on or not self.cuda
        self.ev = None
        self.t0 = self.t1 = 0
        if self.on and self.cuda:
            import torch
            self.stream = torch.cuda.current_stream(device)
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def start(self) -> None:
        if self.ev is not None:
            self.ev[0].record(self.stream)
        elif self.on:
            self.t0 = time.perf_counter_ns()

    def stop(self) -> None:
        if self.ev is not None:
            self.ev[1].record(self.stream)
        elif self.on:
            self.t1 = time.perf_counter_ns()

    def ns(self) -> Optional[int]:
        if self.ev is not None:
            return int(self.ev[0].elapsed_time(self.ev[1]) * 1e6)
        return self.t1 - self.t0 if self.on else None
