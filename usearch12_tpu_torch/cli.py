"""Command line of the port: the JAX package's commands and options, with
usearch_global's hole alignment and sintax's bootstraps on the card.

    python -m usearch12_tpu_torch.cli -usearch_global q.fa -db db.fa \\
        -id 0.97 -strand plus -blast6out hits.b6
    python -m usearch12_tpu_torch.cli -sintax q.fa -db ref.fa \\
        -strand both -tabbedout tax.txt

Every command writes the bytes that python -m usearch12_tpu.cli writes.
Three device paths are not ported yet and exit 2: -mesh (usearch_global,
cluster_mt), -device_rank (usearch_global) and -xprof.  torch is
imported only by the paths that run on the card, so a host command
starts as fast as in the JAX package.
"""

from __future__ import annotations

import resource
import sys
import time
from typing import TYPE_CHECKING, List, Optional

import usearch12_tpu
from usearch12_tpu import runlog
from usearch12_tpu.cli import parse_argv
from usearch12_tpu.config import options

if TYPE_CHECKING:
    from .device import DeviceLike


def _unported(cmd: str) -> List[str]:
    o = options()
    out = []
    if cmd in ("usearch_global", "cluster_mt") and o.filled("mesh"):
        out.append("-mesh")
    if cmd == "usearch_global" and o.flag("device_rank"):
        out.append("-device_rank")
    if o.filled("xprof"):
        out.append("-xprof")
    return out


def main(argv: Optional[List[str]] = None,
         device: DeviceLike = None) -> int:
    """Run one command.  `device` defaults to the CUDA card and is
    resolved only by a command that runs on it; the CPU is used only when
    a caller passes it here."""
    if argv is None:
        argv = sys.argv[1:]
    cmd, cmd_arg = parse_argv(argv)
    if cmd is None:
        print("No command given", file=sys.stderr)
        return 1
    if cmd == "version":
        print(f"usearch12_tpu v{usearch12_tpu.__version__}")
        return 0
    unported = _unported(cmd)
    if unported:
        print(f"{', '.join(unported)}: not yet ported to "
              "usearch12_tpu_torch", file=sys.stderr)
        return 2
    o = options()
    f_log = None
    if o.filled("log"):
        # the JAX CLI's -log header (usearch12_tpu/cli.py:96-107)
        f_log = open(o.str("log"), "w")
        f_log.write(" ".join(["usearch12_tpu"] + argv) + "\n")
        f_log.write(f"usearch12_tpu v{usearch12_tpu.__version__}\n\n")
        f_log.write(time.strftime("Started %a %b %d %H:%M:%S %Y\n\n"))
    t0 = time.time()
    from . import commands
    try:
        commands.run(cmd, cmd_arg, device)
        o.flag("quiet")
        if o.filled("threads"):
            o.uns("threads")
        unused = o.unused_filled()
        if unused and not o.flag("quiet"):
            for u in unused:
                print(f"WARNING: Option -{u} not used", file=sys.stderr)
        if f_log is not None:
            if unused:
                f_log.write("WARNING: Option(s) set but not used: "
                            + " ".join(f"-{u}" for u in unused) + "\n")
            for line in runlog.drain():
                f_log.write(line + "\n")
            peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            f_log.write(f"\nElapsed time {time.time() - t0:.2f} secs\n")
            f_log.write(f"Peak memory {peak_kb / (1 << 20):.1f}Gb\n")
    finally:
        if f_log is not None:
            f_log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
