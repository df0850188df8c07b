"""Human-readable alignment output (-alnout) and FASTA pair output.

WriteAln (src/alnout.cpp:43-166): header with lengths/labels, RowLen-
chunked Qry/annot/Tgt rows with input-space 1-based coordinates, and a
stats footer ("N cols, N ids (pct), N gaps (pct)" plus score/E-value for
local hits).
"""

from __future__ import annotations

import numpy as np

from ..config import options
from ..alpha import MATCH_MX_AMINO, MATCH_MX_NUCLEO, TO_UPPER, IS_ACGTU
from .userout import _row, _hsp


def mem_bytes_to_str(b: float) -> str:
    """MemBytesToStr (src/myutils.cpp:855-870) format tiers."""
    if b < 1e4:
        return f"{b:.1f}b"
    if b < 1e6:
        return f"{b / 1e3:.1f}kb"
    if b < 10e6:
        return f"{b / 1e6:.1f}Mb"
    if b < 1e9:
        return f"{b / 1e6:.0f}Mb"
    if b < 100e9:
        return f"{b / 1e9:.1f}Gb"
    return f"{b / 1e9:.0f}Gb"


def write_program_header(f) -> None:
    """PrintCmdLine + PrintProgramInfo (src/myutils.cpp:1637-1674): the
    reference stamps search -alnout files with the invoking command
    line and 'usearch v12.0 [hash], NGb RAM, N cores'.  Same two-line
    shape here; the bytes necessarily differ in the program token (this
    is not that binary) and wherever RAM/core counts differ — all
    content below is byte-exact (COMPONENTS.md deviations)."""
    import os
    from .. import __version__
    o = options()
    argv = getattr(o, "argv", None) or []
    f.write("usearch12_tpu " + "".join(a + " " for a in argv) + "\n")
    try:
        ram = (os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError):
        ram = 0
    cores = os.cpu_count() or 1
    f.write(f"usearch12_tpu v{__version__}, "
            f"{mem_bytes_to_str(float(ram))} RAM, {cores} cores\n")


def fasta_pair(f, ar) -> None:
    """-fastapairs: aligned query/target rows as FASTA (src/outputsink.cpp)."""
    q = _row(ar, query=True, dots=False)
    t = _row(ar, query=False, dots=False)
    f.write(f">{ar.query_label}\n{q}\n>{ar.target_label}\n{t}\n\n")


def _ndig(n: int) -> int:
    if n < 10:
        return 1
    if n < 100:
        return 2
    if n < 1000:
        return 3
    if n < 10000:
        return 4
    if n < 100000:
        return 5
    if n < 1000000:
        return 6
    return 10


def _annot_sym(qc: str, tc: str, nucleo: bool, subst_mx) -> str:
    """GetAnnotSym (src/arscorer.cpp:12-45)."""
    if qc == "-" or tc == "-":
        return " "
    q, t = ord(qc), ord(tc)
    if nucleo:
        if TO_UPPER[q] == TO_UPPER[t] and IS_ACGTU[q] and IS_ACGTU[t]:
            return "|"
        if MATCH_MX_NUCLEO[q, t]:
            return "+"
        return " "
    if MATCH_MX_AMINO[q, t]:
        return "|"
    score = float(subst_mx[q, t])
    if score >= 2.0:
        return ":"
    if score > 0.0:
        return "."
    return " "


def _pos_to_ipos_q(ar, pos: int, left: bool) -> int:
    """PosToIPosQ (src/arscorer.cpp:598-645)."""
    if ar.orf_frame:
        if ar.orf_frame > 0:
            p = ar.orf_nuc_lo + pos * 3
            return p if left else p + 2
        p = ar.orf_nuc_hi - pos * 3
        return p if left else p - 2
    if ar.query_revcomp:
        return ar.la - pos - 1
    return pos


def _advance(pos: int, row: str) -> tuple:
    """AdvancePos (src/alnout.cpp:27-41)."""
    got = False
    for ch in row:
        if ch != "-":
            if got:
                pos += 1
            else:
                got = True
    return pos, not got


def write_aln(f, ar, subst_mx=None) -> None:
    if f is None:
        return
    o = options()
    f.write("\n")
    iql = ar.orf_nuc_l if ar.orf_frame else ar.la
    itl = ar.lb
    q_nucleo = ar.nucleo or bool(ar.orf_frame)
    t_nucleo = ar.nucleo
    mdig = _ndig(max(iql, itl))
    w = mdig
    f.write(f" Query {iql:>{mdig}}{'nt' if q_nucleo else 'aa'}"
            f" >{ar.query_label}\n")
    f.write(f"Target {itl:>{mdig}}{'nt' if t_nucleo else 'aa'}"
            f" >{ar.target_label}\n")

    q_strand = "." if not ar.nucleo else ("-" if ar.query_revcomp else "+")
    show_strand = q_strand != "."

    qrow = _row(ar, query=True, dots=False)
    trow = _row(ar, query=False, dots=False)
    if subst_mx is None:
        from ..scoring import blosum62_mx
        subst_mx = None if t_nucleo else blosum62_mx()
    annot = "".join(_annot_sym(qc, tc, t_nucleo, subst_mx)
                    for qc, tc in zip(qrow, trow))
    aln_len = len(qrow)
    rowlen = o.uns("rowlen")

    ar._fill()
    if o.flag("show_termgaps"):
        loi, _h, loj, _h2 = _hsp(ar)
        qpos, tpos = loi, loj
    else:
        qpos, tpos = ar.first_m_qpos, ar.first_m_tpos

    q_allgaps = False
    t_allgaps = False
    f.write("\n")
    col = 0
    while col < aln_len:
        hi = min(col + rowlen, aln_len)
        n = hi - col

        q_from = _pos_to_ipos_q(ar, qpos, True) + (0 if q_allgaps else 1)
        t_from = tpos if t_allgaps else tpos + 1

        qpos, q_allgaps = _advance(qpos, qrow[col:hi])
        tpos, t_allgaps = _advance(tpos, trow[col:hi])

        q_to = _pos_to_ipos_q(ar, qpos, False) + (0 if q_allgaps else 1)
        t_to = tpos if t_allgaps else tpos + 1

        if not q_allgaps:
            qpos += 1
        if not t_allgaps:
            tpos += 1

        strand_q = f" {q_strand}" if show_strand else ""
        t_strand = "-" if getattr(ar, "target_revcomp", False) else "+"
        strand_t = f" {t_strand}" if show_strand else ""
        pad = "  " if show_strand else ""
        f.write(f"Qry {q_from:>{w}}{strand_q} {qrow[col:hi]:>{n}}"
                f" {q_to}\n")
        f.write(f"    {'':>{w}}{pad} {annot[col:hi]:>{n}}\n")
        f.write(f"Tgt {t_from:>{w}}{strand_t} {trow[col:hi]:>{n}}"
                f" {t_to}\n")
        f.write("\n")
        col = hi

    if ar.orf_frame:
        f.write(f"Frame {ar.orf_frame:+d}, ")
    id_count = ar.id_count
    gap_count = ar.int_gap_count
    pid = 0.0 if aln_len == 0 else 100.0 * id_count / aln_len
    pgap = 0.0 if aln_len == 0 else 100.0 * gap_count / aln_len
    f.write(f"{aln_len} cols, {id_count} ids ({pid:.1f}%), "
            f"{gap_count} gaps ({pgap:.1f}%)")
    if ar.local:
        if ar.bit_score is None:
            f.write(f", score {ar.raw_score:.1f}")
        else:
            f.write(f", score {ar.raw_score:.1f} ({ar.bit_score:.1f} bits)"
                    f", Evalue {ar.evalue:.2g}")
    f.write("\n")


def _format_seg(lo: int, hi: int, L: int) -> str:
    """FormatSeg (src/outputsink.cpp:57-62)."""
    return f"{lo + 1}-{hi + 1}({L - hi - 1})"


def write_query_report(f, query_label: str, ordered_hits, local: bool,
                       query_nucleo: bool, target_nucleo: bool) -> None:
    """OutputReport (src/outputsink.cpp:243-356): per-query hit table at
    the top of -alnout."""
    if f is None or not ordered_hits:
        return
    f.write(f"\nQuery >{query_label}\n")
    xlat = query_nucleo and not target_nucleo
    if local and xlat:
        f.write(" Score     Evalue   %Id  Frame    QueryLo-Hi(Un)"
                "   TargetLo-Hi(Un)  Target\n")
        for ar in ordered_hits:
            loi, hii, loj, hij = _hsp(ar)
            iqlo = _pos_to_ipos_q(ar, loi, True)
            iqhi = _pos_to_ipos_q(ar, hii, False)
            if ar.orf_frame < 0:
                iqlo, iqhi = iqhi, iqlo   # GetIQLo/Hi swap for -frames
            iql = ar.orf_nuc_l if ar.orf_frame else ar.la
            f.write(f"{ar.raw_score:6.0f}  {ar.evalue:9.1g}"
                    f"  {ar.get_pct_id():3.0f}%  {ar.orf_frame:+5d}"
                    f"  {_format_seg(iqlo, iqhi, iql):>16}"
                    f"  {_format_seg(loj, hij, ar.lb):>16}"
                    f"  {ar.target_label}\n")
    elif local:
        f.write(" Score     Evalue   %Id    QueryLo-Hi(Un)"
                "   TargetLo-Hi(Un)")
        if query_nucleo:
            f.write("  +")
        f.write("  Target\n")
        for ar in ordered_hits:
            loi, hii, loj, hij = _hsp(ar)
            if ar.query_revcomp:
                iqlo, iqhi = ar.la - hii - 1, ar.la - loi - 1
            else:
                iqlo, iqhi = loi, hii
            f.write(f"{ar.raw_score:6.0f}  {ar.evalue:9.1g}"
                    f"  {ar.get_pct_id():3.0f}%"
                    f"  {_format_seg(iqlo, iqhi, ar.la):>16}"
                    f"  {_format_seg(loj, hij, ar.lb):>16}")
            if query_nucleo:
                f.write(f"  {'-' if ar.query_revcomp else '+'}")
            f.write(f"  {ar.target_label}\n")
    else:
        f.write(" %Id   TLen  Target\n")
        for ar in ordered_hits:
            f.write(f"{ar.get_pct_id():3.0f}%  {ar.lb:5d}"
                    f"  {ar.target_label}\n")


def row_to_fasta(f, label: str, row: str) -> None:
    """RowToFasta (src/outputsink.cpp:30-55): gap-stripped row, 80-col."""
    if f is None:
        return
    f.write(f">{label}")
    out_col = 0
    for c in row:
        if c in "-.":
            continue
        if out_col % 80 == 0:
            f.write("\n")
        f.write(c)
        out_col += 1
    f.write("\n")


def write_qseg(f, ar) -> None:
    """OutputQSeg (src/outputsink.cpp:203-222)."""
    if f is None:
        return
    o = options()
    if o.filled("trunclen"):
        n = o.uns("trunclen")
        ar._fill()
        qlo = ar.first_m_qpos + ar.lb
        if qlo + n > ar.la:
            return
        from ..io.fastx import write_fasta
        write_fasta(f, ar.query_label, ar.query_seq[qlo:qlo + n],
                    o.uns("fasta_cols"))
        return
    row_to_fasta(f, ar.query_label, _row(ar, query=True, dots=False))


def write_tseg(f, ar) -> None:
    """OutputTSeg (src/outputsink.cpp:224-229)."""
    if f is None:
        return
    row_to_fasta(f, ar.target_label, _row(ar, query=False, dots=False))


def write_trim(f, ar) -> None:
    """OutputTrim (src/outputsink.cpp): query span after trimming
    terminal deletes, label annotated :lo-hi (1-based)."""
    if f is None:
        return
    from .userout import _trim_info
    from ..io.fastx import write_fasta
    import numpy as np
    qlo, qhi, seg = _trim_info(ar)
    label = f"{ar.query_label}:{qlo + 1}-{qhi + 1}"
    seq = np.frombuffer(seg.encode("latin1"), dtype=np.uint8)
    write_fasta(f, label, seq, options().uns("fasta_cols"))
