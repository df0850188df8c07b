"""Commands of the port.

cmd_usearch_global is the JAX package's cmd_usearch_global
(usearch12_tpu/commands.py) with TorchBatchEngine in place of
BatchEngine, and sintax is the port's own (amplicon/sintax.py).
Every other command has no device code and runs through the JAX
package's own cmd_* (run()), so its per-command defaults stay in one
place.  The device paths still to be ported (-mesh, -device_rank) are
refused by the CLI before a command starts.  torch and the engine are
imported only when the engine runs.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from usearch12_tpu import commands as host_commands
from usearch12_tpu.commands import load_db
from usearch12_tpu.config import options
from usearch12_tpu.engine.batch import engine_eligible
from usearch12_tpu.io.fastx import file_is_nucleo, write_fasta
from usearch12_tpu.out import alnout
from usearch12_tpu.out import uc as uc_mod
from usearch12_tpu.out.blast6 import blast6_line, blast6_no_hits_line
from usearch12_tpu.out.userout import user_out_lines, user_out_no_hits
from usearch12_tpu.search.driver import search_file
from usearch12_tpu.search.hitmgr import HitMgr

from .amplicon.sintax import sintax

if TYPE_CHECKING:
    from .device import DeviceLike

_OUTPUTS = ("blast6out", "alnout", "uc", "matched", "notmatched",
            "fastapairs", "userout", "qsegout", "tsegout", "trimout")


def run(cmd: str, cmd_arg: Optional[str], device: DeviceLike) -> None:
    """Run command `cmd` (a name of usearch12_tpu.cli.COMMANDS other than
    version)."""
    if cmd == "usearch_global":
        cmd_usearch_global(cmd_arg, device)
    elif cmd == "sintax":
        sintax(cmd_arg, device)
    else:
        getattr(host_commands, f"cmd_{cmd}")(cmd_arg)


def cmd_usearch_global(query_path: Optional[str],
                       device: DeviceLike) -> None:
    """usearch_global (src/searchcmd.cpp:6-50, src/search.cpp:89-141):
    the batch engine with the hole DP on `device` where it takes the run,
    else the serial driver (as the JAX package, -use_serial_driver
    included)."""
    o = options()
    if query_path is None:
        query_path = o.str("query")
    if not o.filled("id"):
        raise SystemExit("--id not set")
    db, db_index = load_db(o.str("db"))
    f = {n: open(o.str(n), "w") for n in _OUTPUTS if o.filled(n)}
    if "alnout" in f:
        alnout.write_program_header(f["alnout"])
    dbhit = None
    if (o.filled("dbmatched") or o.filled("dbnotmatched")
            or o.filled("dbcutout")):
        from usearch12_tpu.out.dbhit import DBHitSink
        dbhit = DBHitSink(db)
    no_hits = o.flag("output_no_hits")

    def on_query_done(label, seq, hits):
        hm = HitMgr()
        hm.hits = hits
        ordered = hm.sorted_hits()
        if "alnout" in f:
            q_nucleo = ordered[0].nucleo or bool(ordered[0].orf_frame) \
                if ordered else db.get_is_nucleo()
            alnout.write_query_report(f["alnout"], label, ordered,
                                      local=False, query_nucleo=q_nucleo,
                                      target_nucleo=db.get_is_nucleo())
            for ar in ordered:
                alnout.write_aln(f["alnout"], ar)
        if "blast6out" in f:
            for ar in ordered:
                f["blast6out"].write(blast6_line(ar))
            if not ordered and no_hits:
                f["blast6out"].write(blast6_no_hits_line(label))
        if "userout" in f:
            for ar in ordered:
                f["userout"].write(user_out_lines(ar))
            if not ordered and no_hits:
                f["userout"].write(user_out_no_hits(label, seq))
        if "fastapairs" in f:
            for ar in ordered:
                alnout.fasta_pair(f["fastapairs"], ar)
        if f.keys() & {"qsegout", "tsegout", "trimout"}:
            for ar in ordered:
                alnout.write_qseg(f.get("qsegout"), ar)
                alnout.write_tseg(f.get("tsegout"), ar)
                alnout.write_trim(f.get("trimout"), ar)
        if "uc" in f:
            if ordered:
                for ar in ordered:
                    f["uc"].write(uc_mod.uc_hit_record(ar))
            else:
                f["uc"].write(uc_mod.uc_no_hit_record(label, len(seq)))
        if dbhit:
            dbhit.on_query_done(label, ordered, "usearch_global")
        out = f.get("matched" if ordered else "notmatched")
        if out:
            write_fasta(out, label, seq, o.uns("fasta_cols"))

    try:
        xlat = (not db.get_is_nucleo()) and file_is_nucleo(query_path)
        if engine_eligible("usearch_global", db.get_is_nucleo(), xlat) \
                and not (db_index is not None and db_index.params.hashed) \
                and not o.flag("use_serial_driver"):
            from .device import resolve_device
            from .engine import TorchBatchEngine
            o.flag("no_device_rank")     # the host ranker is the only one
            eng = TorchBatchEngine("usearch_global", db, index=db_index,
                                   device=resolve_device(device))
            if f.keys() == {"blast6out"} and dbhit is None:
                from usearch12_tpu.engine.emit import Blast6Emitter
                eng.run_file(query_path, on_query_done,
                             fast_emit=Blast6Emitter(f["blast6out"], db,
                                                     no_hits))
            else:
                eng.run_file(query_path, on_query_done)
        else:
            search_file("usearch_global", query_path, db, on_query_done,
                        index=db_index)
        if dbhit:
            dbhit.on_all_done()
    finally:
        for fh in f.values():
            fh.close()
