"""Shared helpers of the benchmark's CPU tests: the cells at a size the
CPU holds, run through the harness on the CPU (the kernels' plain
versions), with the look for a card skipped."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("gg99_v4.reads", "gg99_v4.novel")


def tiny_spec(cell: str) -> dict:
    """The cell's spec with its data cut to a CPU's size; the search stays
    above -big (-big 1000)."""
    from benchmark import harness
    spec = harness.cell_spec(cell)
    cfg, tr = spec["config"], spec["traffic"]
    cfg["reference"].update(targets=3000, clusters=1500, clades=30)
    cfg["program_options"] = ["-device_rank", "-big", "1000"]
    tr.update(per_request=64, pool=4, warmup=1)
    tr["check"].update(within=2, row_queries=48)
    return spec


@pytest.fixture
def run_tiny():
    """run_tiny(cell, seed, trace=False, control=False) -> run_cell's
    output, on the CPU, for a window of 0.5 s."""
    from benchmark import harness

    def run(cell, seed=2 ** 31 + 11, trace=False, control=False,
            spec=None):
        return harness.run_cell(spec or tiny_spec(cell), seed, 0.5, trace,
                                device="cpu", control=control)
    return run
