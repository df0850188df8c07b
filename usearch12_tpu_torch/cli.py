"""Command line of the port: the JAX package's argument syntax, with
usearch_global routed to the card.

    python -m usearch12_tpu_torch.cli -usearch_global q.fa -db db.fa \\
        -id 0.97 -strand plus -blast6out hits.b6

Every other command exits 2 with "not yet ported".
"""

from __future__ import annotations

import sys
from typing import List, Optional

from usearch12_tpu.cli import parse_argv
from usearch12_tpu.config import options

from .device import DeviceLike, resolve_device


def main(argv: Optional[List[str]] = None,
         device: DeviceLike = None) -> int:
    """Run one command.  `device` defaults to the CUDA card; the CPU is
    used only when a caller passes it here."""
    if argv is None:
        argv = sys.argv[1:]
    cmd, cmd_arg = parse_argv(argv)
    if cmd is None:
        print("No command given", file=sys.stderr)
        return 1
    unported = [f"-{n}" for n in ("log", "xprof") if options().filled(n)]
    if cmd != "usearch_global":
        unported.insert(0, f"-{cmd}")
    if unported:
        print(f"{', '.join(unported)}: not yet ported to "
              "usearch12_tpu_torch", file=sys.stderr)
        return 2
    dev = resolve_device(device)
    from . import commands
    commands.cmd_usearch_global(cmd_arg, dev)
    options().flag("quiet")
    if options().filled("threads"):
        options().uns("threads")
    unused = options().unused_filled()
    if unused and not options().flag("quiet"):
        for u in unused:
            print(f"WARNING: Option -{u} not used", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
