"""Top-level command implementations (cmd_* entry points).

Each mirrors a reference pipeline (src/searchcmd.cpp, src/clusterfast.cpp,
etc.), composed from the package's engine layers.  usearch_global aligns
its holes on the card (engine/batch.py) and may rank there
(ops/csr_rank.py, or over a -mesh: parallel/mesh_search.py), sintax may
run its boots there (amplicon/sintax.py), and cluster_mt -mesh counts its
words there (parallel/cluster_batch.py); every other command runs on the
host.  torch is imported only when a command runs on the card.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from .config import options
from .engine.batch import engine_eligible
from .io.fastx import file_is_nucleo, write_fasta
from .io.seqdb import SeqDB
from .out import alnout
from .out import uc as uc_mod
from .out.blast6 import blast6_line, blast6_no_hits_line
from .out.userout import user_out_lines, user_out_no_hits
from .search.driver import search_file
from .search.hitmgr import HitMgr

if TYPE_CHECKING:
    from .device import DeviceLike

def _is_udb(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            import struct
            from .index.udbfile import MAGIC1
            return struct.unpack("<I", f.read(4))[0] == MAGIC1
    except Exception:
        return False


def load_db(path: str):
    """LoadDB (src/loaddb.cpp:127): dispatch .udb vs FASTA.  Returns
    (SeqDB, UDBIndex-or-None); .udb DBs are already masked/indexed."""
    if _is_udb(path):
        from .index.udbfile import read_udb
        index, db = read_udb(path)
        if len(db) == 0:
            raise SystemExit("Database is empty")
        return db, index
    db = SeqDB.from_fastx(path)
    if len(db) == 0:
        raise SystemExit("Database is empty")
    db.mask()
    return db, None


def run(cmd: str, cmd_arg: Optional[str], device: DeviceLike) -> None:
    """Run command `cmd` (a name of cli.COMMANDS other than version);
    `device` reaches the commands that run on the card."""
    fn = globals()[f"cmd_{cmd}"]
    if cmd in ("usearch_global", "sintax", "cluster_mt"):
        fn(cmd_arg, device)
    else:
        fn(cmd_arg)


_OUTPUTS = ("blast6out", "alnout", "uc", "matched", "notmatched",
            "fastapairs", "userout", "qsegout", "tsegout", "trimout")


def _mesh(device: DeviceLike):
    """The Mesh of -mesh (parallel/mesh.py), or None when the option is
    unset: "DATAxDB", a device count, or "auto", on `device`'s kind (the
    CUDA cards, or the CPU when the caller passes it).  usearch_global
    ranks over it (parallel/mesh_search.py) and cluster_mt counts its
    words over it (parallel/cluster_batch.py), as in the JAX package
    (usearch12_tpu/commands.py:195-248)."""
    o = options()
    if not o.filled("mesh"):
        return None
    from .parallel.mesh import make_mesh
    return make_mesh(o.str("mesh"), device)


# the DB size from which usearch_global would rank on the engine's device
# without -device_rank (the JAX package's gate is 200,000 targets); None:
# never.  On an H100 the card ranked 220,000 targets more slowly than the
# host as a fresh process (chip_smoke.py's phase 9, PERF.md), so only an
# explicit -device_rank takes it
AUTO_MIN_RANK_TARGETS = None


def _device_rank(eng, dev) -> bool:
    """Whether usearch_global's ranking runs on the card
    (ops/csr_rank.py): asked with -device_rank, or, unless
    -no_device_rank, when the engine has a device and the DB has at least
    AUTO_MIN_RANK_TARGETS targets (where that is set); never for a hashed
    index."""
    o = options()
    forced, refused = o.flag("device_rank"), o.flag("no_device_rank")
    if refused or eng.index.params.hashed:
        return False
    return forced or (dev is not None and AUTO_MIN_RANK_TARGETS is not None
                      and eng.index.seq_count >= AUTO_MIN_RANK_TARGETS)


def cmd_usearch_global(query_path: Optional[str],
                       device: DeviceLike = None) -> None:
    """usearch_global: UDB global search with USORT ranking
    (src/searchcmd.cpp:6-50, src/search.cpp:89-141): the batch engine,
    with the hole DP on `device` unless -no_engine_device and the ranking
    there where _device_rank says, where it takes the run, else the serial
    driver.  With -mesh the engine ranks over the mesh's devices and
    aligns on the host (parallel/mesh_search.py)."""
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
        from .out.dbhit import DBHitSink
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
        eligible = engine_eligible("usearch_global", db.get_is_nucleo(),
                                   xlat) \
            and not (db_index is not None and db_index.params.hashed)
        only_b6 = f.keys() == {"blast6out"} and dbhit is None
        mesh = _mesh(device)
        if mesh is not None:
            if not eligible:
                raise SystemExit("-mesh requires an engine-eligible "
                                 "usearch_global run (global id search, "
                                 "non-hashed index)")
            from .parallel.mesh_search import mesh_search_file
            fast_emit = None
            if only_b6:
                from .engine.emit import Blast6Emitter
                fast_emit = Blast6Emitter(f["blast6out"], db, no_hits)
            mesh_search_file(query_path, db, mesh, on_query_done,
                             fast_emit=fast_emit, index=db_index)
        elif eligible and not o.flag("use_serial_driver"):
            from .engine import BatchEngine
            dev = None
            if not o.flag("no_engine_device"):
                from .device import resolve_device
                dev = resolve_device(device)
            eng = BatchEngine("usearch_global", db, index=db_index,
                              device=dev)
            rank_override = None
            if _device_rank(eng, dev):
                from .device import resolve_device
                from .ops.csr_rank import (CSRDeviceRanker,
                                           make_engine_override)
                ranker = CSRDeviceRanker(
                    eng.index, dev if dev is not None
                    else resolve_device(device),
                    topk=max(64, eng.max_accepts + eng.max_rejects))
                rank_override = make_engine_override(ranker, eng)
            if only_b6:
                from .engine.emit import Blast6Emitter
                eng.run_file(query_path, on_query_done,
                             fast_emit=Blast6Emitter(f["blast6out"], db,
                                                     no_hits),
                             rank_override=rank_override)
            else:
                eng.run_file(query_path, on_query_done,
                             rank_override=rank_override)
        else:
            search_file("usearch_global", query_path, db, on_query_done,
                        index=db_index)
        if dbhit:
            dbhit.on_all_done()
    finally:
        for fh in f.values():
            fh.close()


def cmd_usearch_local(query_path: Optional[str]) -> None:
    """usearch_local: gapped local search with Karlin-Altschul E-values
    (src/searchcmd.cpp:42-45, src/makedbsearcher.cpp:87-127).  -evalue is
    required (oget_flt dies when unset); -id is optional for local."""
    o = options()
    if query_path is None:
        query_path = o.str("query")
    if not o.filled("evalue"):
        raise SystemExit("-evalue required for local search")
    db, db_index = load_db(o.str("db"))


    f_b6 = open(o.str("blast6out"), "w") if o.filled("blast6out") else None
    f_m = open(o.str("matched"), "w") if o.filled("matched") else None
    f_nm = open(o.str("notmatched"), "w") if o.filled("notmatched") else None
    f_user = open(o.str("userout"), "w") if o.filled("userout") else None
    f_aln = open(o.str("alnout"), "w") if o.filled("alnout") else None
    if f_aln:
        alnout.write_program_header(f_aln)
    f_uc = open(o.str("uc"), "w") if o.filled("uc") else None

    def on_query_done(label, seq, hits):
        hm = HitMgr()
        hm.hits = hits
        ordered = hm.sorted_hits()
        maxhits = o.uns("maxhits") if o.filled("maxhits") else 0
        if maxhits > 0:
            ordered = ordered[:maxhits]
        if f_aln:
            q_nucleo = (ordered[0].nucleo or bool(ordered[0].orf_frame)) \
                if ordered else db.get_is_nucleo()
            alnout.write_query_report(f_aln, label, ordered, local=True,
                               query_nucleo=q_nucleo,
                               target_nucleo=db.get_is_nucleo())
            for ar in ordered:
                alnout.write_aln(f_aln, ar)
        if f_b6:
            for ar in ordered:
                f_b6.write(blast6_line(ar))
            if not ordered and o.flag("output_no_hits"):
                f_b6.write(blast6_no_hits_line(label))
        if f_user:
            for ar in ordered:
                f_user.write(user_out_lines(ar))
        if f_uc:
            for ar in ordered:
                f_uc.write(uc_mod.uc_hit_record(ar))
            if not ordered:
                f_uc.write(uc_mod.uc_no_hit_record(label, len(seq)))
        if ordered:
            if f_m:
                write_fasta(f_m, label, seq, o.uns("fasta_cols"))
        else:
            if f_nm:
                write_fasta(f_nm, label, seq, o.uns("fasta_cols"))

    search_file("usearch_local", query_path, db, on_query_done,
                index=db_index)

    for f in (f_b6, f_m, f_nm, f_user, f_aln, f_uc):
        if f:
            f.close()


def cmd_cluster_fast(input_path: Optional[str]) -> None:
    from .cluster.uclust import cluster_fast
    cluster_fast(input_path)


def cmd_cluster_smallmem(input_path: Optional[str]) -> None:
    from .cluster.uclust import cluster_smallmem
    cluster_smallmem(input_path)


def cmd_fastx_uniques(input_path: Optional[str]) -> None:
    from .cluster.derep import fastx_uniques
    fastx_uniques(input_path)


def cmd_unoise3(input_path: Optional[str]) -> None:
    from .amplicon.unoise import unoise3
    unoise3(input_path)


def cmd_uchime3_denovo(input_path: Optional[str]) -> None:
    from .amplicon.uchime import uchime3_denovo
    uchime3_denovo(input_path)


def cmd_sintax(input_path: Optional[str],
               device: DeviceLike = None) -> None:
    from .amplicon.sintax import sintax
    sintax(input_path, device)


def cmd_otutab(input_path: Optional[str]) -> None:
    # cmd_otutab per-command defaults (src/searchcmd.cpp:21-27)
    o = options()
    o.set_default("id", 0.97)
    o.set_default("maxaccepts", 3)
    o.set_default("maxrejects", 32)
    o.set_default("stepwords", 0)
    o.set_default("strand", "both")
    from .amplicon.otutab import otutab
    otutab(input_path)


def cmd_closed_ref(input_path: Optional[str]) -> None:
    # cmd_closed_ref per-command defaults (src/searchcmd.cpp:10-16)
    o = options()
    o.set_default("id", 0.97)
    o.set_default("stepwords", 0)
    from .amplicon.otutab import closed_ref
    closed_ref(input_path)


def cmd_fastq_filter(input_path: Optional[str]) -> None:
    from .fastq.filter import fastq_filter
    fastq_filter(input_path)


def cmd_fastq_mergepairs(input_path: Optional[str]) -> None:
    from .fastq.merge import fastq_mergepairs
    fastq_mergepairs(input_path)


def cmd_fastq_join(input_path: Optional[str]) -> None:
    from .fastq.join import fastq_join
    fastq_join(input_path)


def cmd_fastx_orient(input_path: Optional[str]) -> None:
    from .fastq.orient import fastx_orient
    fastx_orient(input_path)


def cmd_fastx_truncate(input_path: Optional[str]) -> None:
    from .fastq.filter import fastx_truncate
    fastx_truncate(input_path)


def cmd_makeudb_usearch(input_path: Optional[str]) -> None:
    from .index.udbfile import makeudb_usearch
    makeudb_usearch(input_path)


def cmd_fastx_get_sample_names(input_path: Optional[str]) -> None:
    from .amplicon.summary import fastx_get_sample_names
    fastx_get_sample_names(input_path)


def cmd_sintax_summary(input_path: Optional[str]) -> None:
    from .amplicon.summary import sintax_summary
    sintax_summary(input_path)


def cmd_fastq_filter2(input_path: Optional[str]) -> None:
    from .fastq.filter import fastq_filter2
    fastq_filter2(input_path)


def cmd_cluster_mt(input_path: Optional[str],
                   device: DeviceLike = None) -> None:
    """cluster_mt; with -mesh its word counting runs on the mesh's devices
    in batch-synchronous rounds (parallel/cluster_batch.py), writing the
    host path's bytes."""
    mesh = _mesh(device)
    if mesh is not None:
        from .parallel.cluster_batch import cluster_mt_batched
        cluster_mt_batched(input_path, mesh)
        return
    from .cluster.uclust import cluster_mt
    cluster_mt(input_path)


def cmd_cluster_otus(input_path: Optional[str]) -> None:
    from .cluster.uparse import cluster_otus
    cluster_otus(input_path)


def cmd_udb2bitvec(input_path: Optional[str]) -> None:
    from .index.udbfile import udb2bitvec
    udb2bitvec(input_path)


def cmd_search_16s(input_path: Optional[str]) -> None:
    from .amplicon.gene16s import search_16s
    search_16s(input_path)


def cmd_test(_input_path: Optional[str]) -> None:
    """-test: x-drop alignment smoke test (src/xdropalignmem.cpp:336-364)."""
    import numpy as np
    from .alpha import to_bytes
    from .scoring import AlnParams, AlnHeuristics
    from .align.hsp import HSPFinder
    from .align.global_aligner import global_align
    a = to_bytes("SEQVENCE")
    b = to_bytes("SEQVECE")
    from .config import oset
    ap = AlnParams.from_cmdline(False)
    ah = AlnHeuristics.from_cmdline(ap)
    hf = HSPFinder(ap, ah)
    hf.set_a(a)
    hf.set_b(b)
    path = global_align(a, b, ap, ah, hf, fail_if_no_hsps=False)
    print(f"test: {path}")
