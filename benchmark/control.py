"""The control of `correct`: the cell's command module puts it in the
program's place (its Session.control()), and the check must find it.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

runs the cell as run.py does, with the control in place after the
warm-up and the window's first requests judged, and prints each seed's
numbers beside their limits; every seed must come out not correct.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    # the window's first requests are the judged ones, so a short window
    # judges as many as a run does
    chk = spec["traffic"]["check"]
    chk["within"] = chk["requests"]
    ok = True
    for seed in args.seeds:
        out = harness.run_cell(spec, seed, args.seconds, False,
                               t0=time.perf_counter(), control=True)
        res = out["result"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
        ok &= not res["correct"]
    print("control " + ("failed the check on every seed" if ok
                        else "PASSED a seed: no control"), file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
