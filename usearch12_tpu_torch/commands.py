"""Commands of the port.

cmd_usearch_global is the engine branch of the JAX package's
cmd_usearch_global (usearch12_tpu/commands.py) with TorchBatchEngine in
place of BatchEngine.  Everything else that command can do either has
no device code to port or runs a device path that is not ported yet; it
exits with "not yet ported" instead of running something else.
"""

from __future__ import annotations

from typing import Optional

import torch

from usearch12_tpu.commands import load_db
from usearch12_tpu.config import options
from usearch12_tpu.engine.batch import engine_eligible
from usearch12_tpu.io.fastx import file_is_nucleo, write_fasta
from usearch12_tpu.out import uc as uc_mod
from usearch12_tpu.out.blast6 import blast6_line, blast6_no_hits_line
from usearch12_tpu.search.hitmgr import HitMgr

from .engine import TorchBatchEngine

_UNPORTED_OUTPUTS = ("alnout", "userout", "fastapairs", "dbmatched",
                     "dbnotmatched", "dbcutout", "qsegout", "tsegout",
                     "trimout")


def not_yet_ported(what: str) -> SystemExit:
    return SystemExit(f"{what}: not yet ported to usearch12_tpu_torch "
                      "(run usearch12_tpu for it)")


def cmd_usearch_global(query_path: Optional[str],
                       device: torch.device) -> None:
    """usearch_global through the batch engine, hole DP on `device`
    (src/searchcmd.cpp:6-50, src/search.cpp:89-141).  Writes -blast6out,
    -uc, -matched and -notmatched."""
    o = options()
    if o.filled("mesh"):
        raise not_yet_ported("-mesh")
    if o.flag("device_rank"):
        raise not_yet_ported("-device_rank")
    if o.flag("use_serial_driver"):
        raise not_yet_ported("-use_serial_driver (the serial driver)")
    for name in _UNPORTED_OUTPUTS:
        if o.filled(name):
            raise not_yet_ported(f"-{name}")
    if query_path is None:
        query_path = o.str("query")
    if not o.filled("id"):
        raise SystemExit("--id not set")
    db, db_index = load_db(o.str("db"))
    xlat = (not db.get_is_nucleo()) and file_is_nucleo(query_path)
    if not engine_eligible("usearch_global", db.get_is_nucleo(), xlat) \
            or (db_index is not None and db_index.params.hashed):
        raise not_yet_ported("usearch_global outside the batch engine "
                             "(the serial driver)")

    f_b6 = open(o.str("blast6out"), "w") if o.filled("blast6out") else None
    f_uc = open(o.str("uc"), "w") if o.filled("uc") else None
    f_m = open(o.str("matched"), "w") if o.filled("matched") else None
    f_nm = open(o.str("notmatched"), "w") if o.filled("notmatched") else None
    no_hits = o.flag("output_no_hits")

    def on_query_done(label, seq, hits):
        hm = HitMgr()
        hm.hits = hits
        ordered = hm.sorted_hits()
        if f_b6:
            for ar in ordered:
                f_b6.write(blast6_line(ar))
            if not ordered and no_hits:
                f_b6.write(blast6_no_hits_line(label))
        if f_uc:
            if ordered:
                for ar in ordered:
                    f_uc.write(uc_mod.uc_hit_record(ar))
            else:
                f_uc.write(uc_mod.uc_no_hit_record(label, len(seq)))
        f = f_m if ordered else f_nm
        if f:
            write_fasta(f, label, seq, o.uns("fasta_cols"))

    try:
        eng = TorchBatchEngine("usearch_global", db, index=db_index,
                               device=device)
        if f_b6 is not None and not (f_uc or f_m or f_nm):
            from usearch12_tpu.engine.emit import Blast6Emitter
            eng.run_file(query_path, on_query_done,
                         fast_emit=Blast6Emitter(f_b6, db, no_hits))
        else:
            eng.run_file(query_path, on_query_done)
    finally:
        for f in (f_b6, f_uc, f_m, f_nm):
            if f:
                f.close()
