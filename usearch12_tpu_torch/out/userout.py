"""-userout selectable-field output (src/userout.cpp, src/userfields.h).

Implements the full field catalogue with the reference's exact printf
formats (src/userout.cpp:126-260).  Coordinate fields use the reference's
conventions: qlo/qhi = GetIQLo1/GetIQHi1 (1-based, ORF/revcomp-mapped to
the input nucleotide sequence, NO blast6 flip); qlor/... = raw HSP
coords; qlot/... = trimmed (FirstM/LastM) coords.
"""

from __future__ import annotations

import numpy as np

from ..config import options
from ..alpha import (MATCH_MX_AMINO, MATCH_MX_NUCLEO, TO_UPPER,
                     CHAR_TO_LETTER_NUCLEO)

_FIELD_FNS = {}


def _field(*names):
    def deco(fn):
        for n in names:
            _FIELD_FNS[n] = fn
        return fn
    return deco


def _s(seq) -> str:
    return seq.tobytes().decode("latin1")


# ---- coordinate helpers (src/arscorer.cpp:688-760, alignresult.h) --------

def _hsp(ar):
    """(loi, hii, loj, hij): the AR's HSP (full spans for global)."""
    if ar.local:
        return (ar.loi, ar.loi + ar.leni_local - 1,
                ar.loj, ar.loj + ar.lenj_local - 1)
    return 0, ar.la - 1, 0, ar.lb - 1


def _iq_lo_hi(ar):
    """GetIQLo/GetIQHi: query coords mapped to the input nt sequence."""
    loi, hii, _lj, _hj = _hsp(ar)
    if ar.orf_frame:
        if ar.orf_frame > 0:
            return ar.orf_nuc_lo + loi * 3, ar.orf_nuc_lo + hii * 3 + 2
        return ar.orf_nuc_hi - hii * 3 - 2, ar.orf_nuc_hi - loi * 3
    if ar.query_revcomp:
        return ar.la - hii - 1, ar.la - loi - 1
    return loi, hii


def _iql(ar) -> int:
    return ar.orf_nuc_l if ar.orf_frame else ar.la


# ---- fields ---------------------------------------------------------------

@_field("query")
def _query(ar):
    return ar.query_label


@_field("target")
def _target(ar):
    return ar.target_label


@_field("clusternr")
def _clusternr(ar):
    return "*" if ar.target_index < 0 else str(ar.target_index)


@_field("evalue")
def _evalue(ar):
    # GetEvalue returns -1.0 for non-local hits (src/arscorer.cpp:69-73)
    if not getattr(ar, "local", False) or ar.evalue is None:
        return "-1"
    return f"{ar.evalue:.3g}"


@_field("id")
def _id(ar):
    return f"{ar.get_pct_id():.1f}"


@_field("fractid")
def _fractid(ar):
    return f"{ar.get_fract_id():.4f}"


@_field("dist")
def _dist(ar):
    return f"{1.0 - ar.get_fract_id():.4f}"


@_field("mid")
def _mid(ar):
    ar._fill()
    n = ar.id_count + ar.mismatch_count
    v = 0.0 if ar.id_count == 0 else ar.id_count / n
    return f"{100.0 * v:.1f}"


@_field("pctpv")
def _pctpv(ar):
    n = _positive_count(ar)
    return f"{_pct(n, ar.get_aln_length()):.1f}"


@_field("pctgaps")
def _pctgaps(ar):
    ar._fill()
    return f"{_pct(ar.int_gap_count, ar.aln_length):.1f}"


@_field("pairs")
def _pairs(ar):
    ar._fill()
    return str(ar.id_count + ar.mismatch_count)


@_field("gaps")
def _gaps(ar):
    return str(ar.get_gap_count())


@_field("allgaps")
def _allgaps(ar):
    ar._fill()
    return str(ar.int_gap_count + ar.term_gap_count)


@_field("qlo")
def _qlo(ar):
    return str(_iq_lo_hi(ar)[0] + 1)


@_field("qhi")
def _qhi(ar):
    return str(_iq_lo_hi(ar)[1] + 1)


@_field("tlo")
def _tlo(ar):
    return str(_hsp(ar)[2] + 1)


@_field("thi")
def _thi(ar):
    return str(_hsp(ar)[3] + 1)


@_field("qlor")
def _qlor(ar):
    return str(_hsp(ar)[0])


@_field("qhir")
def _qhir(ar):
    return str(_hsp(ar)[1])


@_field("tlor")
def _tlor(ar):
    return str(_hsp(ar)[2])


@_field("thir")
def _thir(ar):
    return str(_hsp(ar)[3])


@_field("qlot")
def _qlot(ar):
    ar._fill()
    return str(ar.first_m_qpos)


@_field("qhit")
def _qhit(ar):
    ar._fill()
    return str(ar.last_m_qpos)


@_field("qunt")
def _qunt(ar):
    ar._fill()
    return str(_iql(ar) - ar.last_m_qpos - 1)


@_field("tlot")
def _tlot(ar):
    ar._fill()
    return str(ar.first_m_tpos)


@_field("thit")
def _thit(ar):
    ar._fill()
    return str(ar.last_m_tpos)


@_field("tunt")
def _tunt(ar):
    ar._fill()
    return str(ar.lb - ar.last_m_tpos - 1)


@_field("orflo")
def _orflo(ar):
    return str(ar.orf_nuc_lo if ar.orf_frame else 0)


@_field("orfhi")
def _orfhi(ar):
    return str(ar.orf_nuc_hi if ar.orf_frame else 0)


@_field("orfframe")
def _orfframe(ar):
    return f"{ar.orf_frame:+d}"


@_field("orfseqnt")
def _orfseqnt(ar):
    """UF_orfseqnt (src/userout.cpp:270-287): the ORF's nucleotide span
    of the PLUS-strand query (m_ORFNucSeq is the untranslated query for
    both strands, src/orffinder.cpp:147)."""
    if not ar.orf_frame:
        return "(not_orf)"
    nuc = ar.orf_nuc_seq
    return bytes(nuc[ar.orf_nuc_lo:ar.orf_nuc_hi + 1]).decode("latin1")


@_field("orfsegnt")
def _orfsegnt(ar):
    """UF_orfsegnt (src/userout.cpp:289-311): nucleotides under the
    aligned amino segment — Seq[NtLo+3*QLo .. +3*QHi], one short of the
    final codon (the reference's QHi-QLo+1 length quirk)."""
    if not ar.orf_frame:
        return "(not_orf)"
    ar._fill()
    nuc = ar.orf_nuc_seq
    qlo3 = 3 * ar.first_m_qpos
    qhi3 = 3 * ar.last_m_qpos
    seg_len = qhi3 - qlo3 + 1
    lo = ar.orf_nuc_lo + qlo3
    return bytes(nuc[lo:lo + seg_len]).decode("latin1")


@_field("orfseqaa")
def _orfseqaa(ar):
    """UF_orfseqaa (src/userout.cpp:312-344): codon-by-codon translation
    of NtLo..NtHi via g_CodonWordToAminoChar; invalid codons => 'X'.
    The reference asserts Frame > 0 here."""
    if not ar.orf_frame:
        return "(not_orf)"
    from ..alpha import CHAR_TO_LETTER_NUCLEO, CODON_WORD_TO_AMINO_CHAR
    nuc = ar.orf_nuc_seq
    out = []
    pos = ar.orf_nuc_lo
    while pos <= ar.orf_nuc_hi:
        x1 = int(CHAR_TO_LETTER_NUCLEO[nuc[pos]])
        x2 = int(CHAR_TO_LETTER_NUCLEO[nuc[pos + 1]])
        x3 = int(CHAR_TO_LETTER_NUCLEO[nuc[pos + 2]])
        word = 16 * x1 + 4 * x2 + x3
        if word >= 64 or word < 0:
            out.append("X")
        else:
            out.append(chr(CODON_WORD_TO_AMINO_CHAR[word]))
        pos += 3
    return "".join(out)


@_field("pv")
def _pv(ar):
    return str(_positive_count(ar))


@_field("ql")
def _ql(ar):
    return str(_iql(ar))


@_field("tl")
def _tl(ar):
    return str(ar.lb)


@_field("qs")
def _qs(ar):
    return str(ar.leni_local if ar.local else ar.la)


@_field("ts")
def _ts(ar):
    return str(ar.lenj_local if ar.local else ar.lb)


@_field("alnlen")
def _alnlen(ar):
    return str(ar.get_aln_length())


@_field("opens")
def _opens(ar):
    return str(ar.get_gap_open_count())


@_field("exts")
def _exts(ar):
    ar._fill()
    n = 0
    lastc = "M"
    for col in range(ar.first_m_col, ar.last_m_col + 1):
        c = ar.path[col]
        if c != "M" and lastc != "M":
            n += 1
        lastc = c
    return str(n)


@_field("raw")
def _raw(ar):
    return f"{ar.raw_score:.0f}"


@_field("bits")
def _bits(ar):
    return f"{(ar.bit_score if ar.bit_score is not None else 0.0):.0f}"


@_field("aln")
def _aln(ar):
    return ar.path


@_field("caln")
def _caln(ar):
    return ar.compressed_path()


@_field("qstrand")
def _qstrand(ar):
    """GetQueryStrand (src/arscorer.cpp:156-165): '.' for amino (ORF
    queries align as amino, so translated search prints '.')."""
    if not ar.nucleo:
        return "."
    return "-" if ar.query_revcomp else "+"


@_field("tstrand")
def _tstrand(ar):
    return "." if not ar.nucleo else "+"


@_field("qrow")
def _qrow(ar):
    return _row(ar, query=True, dots=False)


@_field("trow")
def _trow(ar):
    return _row(ar, query=False, dots=False)


@_field("qrowdots")
def _qrowdots(ar):
    return _row(ar, query=True, dots=True)


@_field("trowdots")
def _trowdots(ar):
    return _row(ar, query=False, dots=True)


@_field("qframe")
def _qframe(ar):
    return f"{(ar.orf_frame if ar.orf_frame else 0):+d}"


@_field("tframe")
def _tframe(ar):
    return "+0"


@_field("mism")
def _mism(ar):
    return str(ar.get_mismatch_count())


@_field("ids")
def _ids(ar):
    ar._fill()
    return str(ar.id_count)


@_field("qcov")
def _qcov(ar):
    return f"{100.0 * ar.get_query_cov():.0f}"


@_field("tcov")
def _tcov(ar):
    return f"{100.0 * ar.get_target_cov():.0f}"


@_field("diffs")
def _diffs(ar):
    return str(ar.get_diff_count())


@_field("diffsa")
def _diffsa(ar):
    ar._fill()
    return str(ar.diff_count_a)


@_field("editdiffs")
def _editdiffs(ar):
    ar._fill()
    return str(ar.mismatch_count + ar.int_gap_count + ar.term_gap_count)


@_field("abskew")
def _abskew(ar):
    from ..io.seqdb import size_from_label
    qs = size_from_label(ar.query_label, 1)
    ts = size_from_label(ar.target_label, 1)
    return f"{(ts / qs if qs else 0.0):.1f}"


@_field("qseq")
def _qseq(ar):
    return _s(ar.query_seq)


@_field("tseq")
def _tseq(ar):
    return _s(ar.target_seq)


@_field("qseg")
def _qseg(ar):
    # fprintf "%*.*s" with width/precision = HSP Leni over the buffer at
    # GetQuerySeg() (seq + FirstMQPos, NUL right after the sequence):
    # with leading terminal gaps the string is shorter than the width
    # and printf left-pads with spaces (src/userout.cpp:217)
    ar._fill()
    loi, hii, _lj, _hj = _hsp(ar)
    n = hii - loi + 1
    return _s(ar.query_seq[ar.first_m_qpos:ar.first_m_qpos + n]).rjust(n)


@_field("tseg")
def _tseg(ar):
    ar._fill()
    _li, _hi, loj, hij = _hsp(ar)
    n = hij - loj + 1
    return _s(ar.target_seq[ar.first_m_tpos:ar.first_m_tpos + n]).rjust(n)


@_field("qsegf")
def _qsegf(ar):
    return _segf(ar, query=True)


@_field("tsegf")
def _tsegf(ar):
    return _segf(ar, query=False)


@_field("gc")
def _gc(ar):
    loi, hii, _lj, _hj = _hsp(ar)
    seg = ar.query_seq[loi:hii + 1]
    if len(seg) == 0:
        return "0.0"
    lets = CHAR_TO_LETTER_NUCLEO[seg]
    n = int(np.count_nonzero((lets == 1) | (lets == 2)))
    return f"{100.0 * n / len(seg):.1f}"


@_field("kmerid")
def _kmerid(ar):
    return f"{_kmer_id(ar):.4f}"


@_field("qtrimlo")
def _qtrimlo(ar):
    return str(_trim_info(ar)[0] + 1)


@_field("qtrimhi")
def _qtrimhi(ar):
    return str(_trim_info(ar)[1] + 1)


@_field("qtrimseq")
def _qtrimseq(ar):
    return _trim_info(ar)[2]


# ---- helpers ---------------------------------------------------------------

def _pct(n, d):
    return 0.0 if d == 0 else 100.0 * n / d


def _positive_count(ar):
    """GetPositiveCount (src/arscorer.cpp:534-552)."""
    from ..scoring import AlnParams
    ar._fill()
    mx = ar._subst_mx if hasattr(ar, "_subst_mx") else None
    if mx is None:
        from ..scoring import nuc_mx, blosum62_mx
        mx = nuc_mx(options().flt("match", 1.0),
                    options().flt("mismatch", -2.0)) if ar.nucleo \
            else blosum62_mx()
    q = ar.query_seq
    t = ar.target_seq
    # GetQuerySeg/GetTargetSeg start at the first aligned column's
    # positions (leading terminal gaps consume positions before it)
    qpos, tpos = ar.first_m_qpos, ar.first_m_tpos
    n = 0
    for col in range(ar.first_m_col, ar.last_m_col + 1):
        c = ar.path[col]
        if c == "M" and mx[q[qpos], t[tpos]] > 0.0:
            n += 1
        if c in "MD":
            qpos += 1
        if c in "MI":
            tpos += 1
    return n


def _row(ar, query: bool, dots: bool) -> str:
    """GetQueryRow/GetTargetRow[...Dots] (src/arscorer.cpp:305-455)."""
    ar._fill()
    o = options()
    loi, _hii, loj, _hij = _hsp(ar)
    q = ar.query_seq
    t = ar.target_seq
    mx = MATCH_MX_NUCLEO if ar.nucleo else MATCH_MX_AMINO
    # positions at the first rendered column: leading terminal-gap
    # columns consume query/target positions before first_m_col
    first, last = ar.first_m_col, ar.last_m_col
    qpos, tpos = ar.first_m_qpos, ar.first_m_tpos
    if o.flag("show_termgaps"):
        first, last = 0, len(ar.path) - 1
        qpos, tpos = loi, loj
    out = []
    for col in range(first, last + 1):
        c = ar.path[col]
        qc = chr(TO_UPPER[q[qpos]]) if c in "MD" else "-"
        tc = chr(TO_UPPER[t[tpos]]) if c in "MI" else "-"
        if query:
            ch = qc
            if dots and c in "MD" and mx[ord(qc), ord(tc) if tc != "-"
                                         else ord("-")]:
                ch = "."
        else:
            ch = tc
            if dots and c in "MI" and mx[ord(qc) if qc != "-" else ord("-"),
                                         ord(tc)]:
                ch = "."
        out.append(ch)
        if c in "MD":
            qpos += 1
        if c in "MI":
            tpos += 1
    return "".join(out)


def _segf(ar, query: bool) -> str:
    """qsegf/tsegf: '-'-delimited segment with up to -flank context
    (src/userout.cpp:225-268).  Note tsegf computes its right flank from
    the QUERY Hii — a reference quirk replicated here."""
    o = options()
    f = o.uns("flank", 8)
    loi, hii, loj, hij = _hsp(ar)
    if query:
        seq, lo, hi = ar.query_seq, loi, hii
        seg_len = hii - loi + 1
    else:
        seq, lo = ar.target_seq, loj
        seg_len = hij - loj + 1
        hi = hii   # reference bug: fr uses GetHii() for tsegf too
    L = len(seq)
    fl = min(lo, f)
    fr = (L - hi - 1) & 0xFFFFFFFF   # unsigned wrap like the reference
    if fr > f:
        fr = f
    left = _s(seq[lo - fl:lo]) if fl > 0 else ""
    mid = _s(seq[lo:lo + seg_len])
    # printf "%*.*s": reading past the sequence end hits the NUL, so a
    # short (or empty) right flank is space-padded to width fr
    right = _s(seq[lo + seg_len:lo + seg_len + fr]).rjust(fr) \
        if fr > 0 else ""
    return f"{left}-{mid}-{right}"


def _kmer_id(ar) -> float:
    """GetKmerId (src/arscorer.cpp:882-931)."""
    o = options()
    w = o.uns("wordlength") if o.filled("wordlength") else 8
    min_l = min(ar.la, ar.lb)
    if min_l < w:
        return 0.0
    kmer_count = min_l - w + 1
    ar._fill()
    loi, _hii, loj, _hij = _hsp(ar)
    qpos, tpos = ar.first_m_qpos, ar.first_m_tpos
    q, t = ar.query_seq, ar.target_seq
    match = 0
    run = 0
    for col in range(ar.first_m_col, ar.last_m_col + 1):
        c = ar.path[col]
        if c == "M":
            if TO_UPPER[q[qpos]] == TO_UPPER[t[tpos]]:
                run += 1
            else:
                run = 0
            if run >= w:
                match += 1
            qpos += 1
            tpos += 1
        elif c == "D":
            run = 0
            qpos += 1
        else:
            run = 0
            tpos += 1
    return min(1.0, match / kmer_count)


def _trim_info(ar):
    """GetTrimInfo (src/arscorer.cpp:933-970): query span after trimming
    terminal deletes."""
    ql = ar.la
    if ql == 0:
        return 0, 0, ""
    qlo, qhi = 0, ql - 1
    path = ar.path
    # run-length ops
    ops = []
    i = 0
    while i < len(path):
        j = i
        while j < len(path) and path[j] == path[i]:
            j += 1
        ops.append((path[i], j - i))
        i = j
    if ops and ops[0][0] == "D":
        qlo = ops[0][1]
    if ops and ops[-1][0] == "D":
        new_qhi = ql - ops[-1][1] - 1
        if new_qhi > qlo:
            qhi = new_qhi
    seg = _s(ar.query_seq[qlo:qhi])
    return qlo, qhi, seg


def user_out_lines(ar) -> str:
    fields = options().str("userfields").split("+")
    vals = []
    for f in fields:
        fn = _FIELD_FNS.get(f)
        if fn is None:
            raise SystemExit(f"Invalid user field name '{f}'")
        vals.append(fn(ar))
    return "\t".join(vals) + "\n"


def user_out_no_hits(query_label: str, query_seq, cluster_index=None) -> str:
    """OutputUserNoHits (src/userout.cpp:53-124)."""
    fields = options().str("userfields").split("+")
    vals = []
    for f in fields:
        if f == "query":
            vals.append(query_label)
        elif f == "ql":
            vals.append(str(len(query_seq)))
        elif f == "qseq":
            vals.append(_s(query_seq))
        elif f == "clusternr" and cluster_index is not None:
            vals.append(str(cluster_index))
        else:
            vals.append("*")
    return "\t".join(vals) + "\n"
