"""usearch-compatible command line driver of the port, with
usearch_global's hole alignment and ranking and sintax's bootstraps on
the card.

Invocation mirrors the reference (src/usearch_main.cpp, src/getcmd.cpp):
the first -flag that names a command selects it; all other -flag [value]
pairs populate the option registry.

    python -m usearch12_tpu_torch.cli -usearch_global q.fa -db db.fa \\
        -id 0.97 -strand plus -blast6out hits.b6
    python -m usearch12_tpu_torch.cli -sintax q.fa -db ref.fa \\
        -strand both -tabbedout tax.txt

Every command writes the bytes that the JAX package's CLI writes, with
every option of that CLI: -mesh DATAxDB (usearch_global, cluster_mt) runs
on a mesh of cards, or of CPU entries when the caller passes the CPU, and
-xprof DIR writes a torch.profiler Chrome trace of the command into DIR,
which holds usearch_global's stage ranges (usearch.request, .parse, .rank,
.rank_prepare, .rank_finish, .round, .chain, .holes, .replay, .emit, .save;
obs.py) on the clock of the card's kernels.
torch is imported only by the paths that run on the card in this process
and by -xprof, so a host command starts as fast as in the JAX package.
When the caller passes no device, usearch_global's and sintax's card work
goes to the resident device server (device_server.py: started by the
first run that needs it, or by `python -m usearch12_tpu_torch.device_server
--device cuda`), and this process imports no torch at all; where no
server can be reached or started, the work runs on the card in this
process, after a line on stderr that says why.
"""

from __future__ import annotations

import resource
import sys
import time
from typing import TYPE_CHECKING, List, Optional

from . import __version__, runlog
from .config import options, reset_options

if TYPE_CHECKING:
    from .device import DeviceLike

COMMANDS = [
    "cluster_fast", "cluster_otus", "cluster_smallmem", "cluster_mt",
    "closed_ref", "fastq_filter", "fastq_filter2", "fastq_join",
    "fastq_mergepairs", "fastx_orient", "fastx_uniques", "fastx_truncate",
    "fastx_get_sample_names", "makeudb_usearch", "sintax_summary",
    "uchime3_denovo", "unoise3", "usearch_global", "usearch_local",
    "sintax", "otutab", "search_16s", "udb2bitvec", "test", "version",
]

_FLAG_OPTS_NO_VALUE = {
    "quiet", "self", "notself", "selfid", "gaforce", "fulldp", "quicksort",
    "top_hit_only", "top_hits_only", "output_no_hits", "show_termgaps",
    "hardmask", "sizein",
    "sizeout", "fastq_eeout", "fastq_nostagger",
    "interleaved", "uc_hitsonly", "trunclabels",
    "maxskew", "tov", "log_objmgr_stats", "log_touched_opts",
    "no_progress", "version",
    "use_cpu_oracle", "notrunclabels", "orf_plusonly",
    "engine_device", "no_engine_device", "use_serial_driver", "device_rank",
    "no_device_rank", "sintax_device", "no_sintax_device",
    "ignore_label_mismatches", "fastq_forceq", "fastq_noguess", "keepgaps",
}


def parse_argv(argv: List[str]):
    """Returns (cmd, cmd_arg) and fills the option registry."""
    opts = reset_options()
    opts.argv = list(argv)      # for PrintCmdLine-style file banners
    cmd = None
    cmd_arg = None
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-"):
            raise SystemExit(f"Expected -flag, got '{tok}'")
        name = tok.lstrip("-")
        if name in COMMANDS:
            if cmd is not None:
                raise SystemExit(f"Two commands: {cmd}, {name}")
            cmd = name
            # command flag takes the input filename as its value (if any)
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                cmd_arg = argv[i + 1]
                i += 1
        elif name in _FLAG_OPTS_NO_VALUE:
            opts.declare(name, "flag", False)
            opts.set(name, True)
        else:
            # strict registry like the reference's MyCmdLine
            # (src/opts.cpp): options not in the o_*.h lists (plus our
            # documented extensions) are rejected
            if not opts.known(name):
                raise SystemExit(f"Unknown command-line option -{name}")
            if i + 1 >= len(argv):
                raise SystemExit(f"Command line error, missing value for '{name}'")
            val = argv[i + 1]
            opts.declare(name, "str")
            opts.set(name, val)
            i += 1
        i += 1
    return cmd, cmd_arg


def _profiler(device: DeviceLike):
    """torch.profiler over the whole command for -xprof DIR, started; CUDA
    activity too unless the caller passed the CPU or there is no card.
    The program's stages enter their usearch.* ranges while it records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and (
            device is None or torch.device(device).type == "cuda"):
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _write_trace(prof, cmd: str, xprof: str) -> None:
    """Stop the profiler and write its Chrome trace into the directory
    xprof."""
    import os
    prof.stop()
    os.makedirs(xprof, exist_ok=True)
    path = os.path.join(xprof, f"usearch12_tpu_torch.{cmd}.{os.getpid()}"
                        ".trace.json")
    prof.export_chrome_trace(path)


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
        print(f"usearch12_tpu v{__version__}")
        return 0
    o = options()
    f_log = None
    if o.filled("log"):
        # the reference's SetLogFileName / LogElapsedTimeAndRAM
        # (src/myutils.cpp:843,1451); the program name stays
        # usearch12_tpu, as in every output of the port
        f_log = open(o.str("log"), "w")
        f_log.write(" ".join(["usearch12_tpu"] + argv) + "\n")
        f_log.write(f"usearch12_tpu v{__version__}\n\n")
        f_log.write(time.strftime("Started %a %b %d %H:%M:%S %Y\n\n"))
    t0 = time.time()
    from . import commands
    # -xprof DIR: a torch.profiler trace of the whole command, the
    # counterpart of the JAX package's jax.profiler trace
    xprof = o.str("xprof") if o.filled("xprof") else None
    try:
        prof = _profiler(device) if xprof else None
        try:
            commands.run(cmd, cmd_arg, device)
        finally:
            if prof is not None:
                _write_trace(prof, cmd, xprof)
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
