"""Run one cell of the benchmark of usearch12_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result, one JSON object (correct, attempted, failed, metrics, device; with
--trace 1 the per-layer metrics, the device's busy seconds and a
breakdown; the numbers compared for `correct` last, under "checks");
standard error ends with those numbers beside their limits.  Exits 2,
printing no result, without the CUDA cards the cell asks for, and 3 when
a module that no run may load (jax, jaxlib, flax, usearch12_tpu) was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from benchmark import harness
    spec = harness.cell_spec(args.workload)
    try:
        out = harness.run_cell(spec, args.seed, args.seconds,
                               bool(args.trace), t0=T0)
    except harness.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except harness.Blocked as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    for line in out["log"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    for name, value, limit in out["checks"]:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
