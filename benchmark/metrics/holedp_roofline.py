"""The hole DP's kernels' share of their bound, in %: the least time of
the traced window's dispatched holes (reference/holes.py:hole_bound, from
each hole's lengths and the band alone, never from the program's
counters) over the trace's time of the port's hole DP kernels, whose
names start with "wavefront_" (a kernel's name may carry its return type,
"void ", in front).  None where the trace holds none of them."""

import numpy as np

from benchmark.reference import holes


def _hole_kernel(name: str) -> bool:
    return name.removeprefix("void ").startswith("wavefront_")


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    t = sum(s for name, s in tr["device_ops"] if _hole_kernel(name))
    lens = [h for r in run["requests"] if "error" not in r
            for h in r.get("dev_holes", ())]
    if t <= 0 or not lens:
        return None
    bound = holes.hole_bound(np.concatenate([a for a, _ in lens]),
                             np.concatenate([b for _, b in lens]),
                             run["config"]["search"]["band"])
    return 100.0 * bound / t
