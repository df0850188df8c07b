"""fastq_mergepairs / fastq_join (src/merge*.cpp, src/fastqjoin.cpp).

Merge: HSP seeding of fwd vs revcomp(rev) (StaggerOk), top HSP extended to
the full overlap along its diagonal, gates (minovlen, stagger, maxdiffs,
pctid), posterior quality combination for the overlap, post filters.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..alpha import revcomp
from ..config import options
from ..io.fastx import read_fastq, write_fasta, write_fastq
from ..scoring import AlnParams, AlnHeuristics
from ..align.hsp import HSPFinder
from .qual import get_fastq
from .filter import Relabeler


def trunc_label(label: str) -> str:
    for i, c in enumerate(label):
        if c in " \t":
            return label[:i]
    return label


def illumina_label_pair_match(l1: str, l2: str) -> bool:
    o = options()
    if o.flag("ignore_label_mismatches"):
        return True
    if len(l1) != len(l2):
        return False
    found = False
    for c1, c2 in zip(l1, l2):
        if c1 != c2:
            if found:
                return False
            if c1 != "1" or (c2 != "2" and c2 != "3"):
                return False
            found = True
    return True


def _truncate_tail(seq, qual, fq) -> tuple:
    """SeqInfo::TruncateTail via fastq_trunctail (src/mergepre.cpp)."""
    o = options()
    tt = o.uns("fastq_trunctail")
    tail = 0
    for k in range(len(seq)):
        if fq.char_to_int(ord(qual[len(seq) - k - 1])) <= tt:
            tail += 1
        else:
            break
    if tail > 0 and tail > o.uns("fastq_tail"):
        n = len(seq) - tail
        return seq[:n], qual[:n]
    return seq, qual


def _extend_hsp(ql: int, tl: int, loi: int, loj: int):
    """ExtendHSP (src/mergealign.cpp:13-39)."""
    lo_i = 0 if loi <= loj else loi - loj
    lo_j = 0 if loj <= loi else loj - loi
    len_i = ql - lo_i
    len_j = tl - lo_j
    length = min(len_i, len_j)
    return lo_i, lo_j, length


class MergeStats:
    """The reference's g_* merge counters (src/mergestats.cpp)."""

    def __init__(self) -> None:
        self.in_recs = 0
        self.out_recs = 0
        self.tail1 = 0
        self.tail2 = 0
        self.tooshort1 = 0
        self.tooshort2 = 0
        self.notaligned = 0
        self.ovtooshort = 0
        self.staggered = 0
        self.exact = 0
        self.maxdiffs = 0
        self.minq = 0
        self.merged_tooshort = 0
        self.merged_toolong = 0
        self.sum_ov_length = 0.0
        self.sum_merged_length = 0.0
        self.sum_ee1 = 0.0
        self.sum_ee2 = 0.0
        self.sum_merged_ee = 0.0
        self.merge_lengths = []

    def report_strs(self):
        """GetMergeStatsStrs (src/mergestats.cpp:24-105)."""
        o = options()
        out = []

        def pct(n, d):
            return 0.0 if d == 0 else 100.0 * n / d

        # the reference prints the block whenever -report allocated the
        # vector; GetQuarts of an empty vector is all zeros
        # (src/mergestats.cpp:5-22, src/quarts.cpp:5-16)
        ls = sorted(self.merge_lengths)
        n = len(ls)

        def at(i):
            return ls[i] if n else 0
        out.append("")
        out.append("Merged length distribution:")
        out.append(f"{at(0):10d}  Min")
        out.append(f"{at(n // 4):10d}  Low quartile")
        out.append(f"{at(n // 2):10d}  Median")
        out.append(f"{at((3 * n) // 4):10d}  High quartile")
        out.append(f"{at(n - 1):10d}  Max")

        out.append("")
        out.append(f"{self.in_recs:10d}  Read pairs"
                   f" ({_int_str(self.in_recs)})")
        out.append(f"{self.out_recs:10d}  Merged ({_int_str(self.out_recs)}"
                   f", {pct(self.out_recs, self.in_recs):.2f}%)")
        if self.in_recs == 0:
            return out
        out.append(f"{self.exact:10d}  Alignments with zero diffs"
                   f" ({pct(self.exact, self.in_recs):.2f}%)")
        out.append(f"{self.maxdiffs:10d}  Too many diffs"
                   f" (> {o.uns('fastq_maxdiffs')})"
                   f" ({pct(self.maxdiffs, self.in_recs):.2f}%)")
        if self.tail1 > 0 or self.tail2 > 0:
            tt = o.uns("fastq_trunctail")
            out.append(f"{self.tail1:10d}  Fwd tails Q <= {tt} trimmed"
                       f" ({pct(self.tail1, self.in_recs):.2f}%)")
            out.append(f"{self.tail2:10d}  Rev tails Q <= {tt} trimmed"
                       f" ({pct(self.tail2, self.in_recs):.2f}%)")
        if self.tooshort1 > 0 or self.tooshort2 > 0:
            ml = o.uns("fastq_minlen")
            out.append(f"{self.tooshort1:10d}  Fwd too short (< {ml}) after"
                       f" tail trimming"
                       f" ({pct(self.tooshort1, self.in_recs):.2f}%)")
            out.append(f"{self.tooshort2:10d}  Rev too short (< {ml}) after"
                       f" tail trimming"
                       f" ({pct(self.tooshort2, self.in_recs):.2f}%)")
        out.append(f"{self.notaligned:10d}  No alignment found"
                   f" ({pct(self.notaligned, self.in_recs):.2f}%)")
        out.append(f"{self.ovtooshort:10d}  Alignment too short"
                   f" (< {o.uns('fastq_minovlen')})"
                   f" ({pct(self.ovtooshort, self.in_recs):.2f}%)")
        if o.filled("fastq_minmergelen"):
            out.append(f"{self.merged_tooshort:10d}  Merged too short"
                       f" (< {o.uns('fastq_minmergelen')})")
        if o.filled("fastq_maxmergelen"):
            out.append(f"{self.merged_toolong:10d}  Merged too long"
                       f" (> {o.uns('fastq_maxmergelen')})")
        if o.filled("fastq_minqual"):
            out.append(f"{self.minq:10d}  Min Q too low"
                       f" (<{o.uns('fastq_minqual')})"
                       f" ({pct(self.minq, self.in_recs):.2f}%)")
        s = (f"{self.staggered:10d}  Staggered pairs"
             f" ({pct(self.staggered, self.in_recs):.2f}%)")
        s += " discarded" if o.flag("fastq_nostagger") \
            else " merged & trimmed"
        out.append(s)
        if self.out_recs == 0:
            return out
        out.append(f"{self.sum_ov_length / self.out_recs:10.2f}"
                   f"  Mean alignment length")
        out.append(f"{self.sum_merged_length / self.out_recs:10.2f}"
                   f"  Mean merged length")
        out.append(f"{self.sum_ee1 / self.out_recs:10.2f}"
                   f"  Mean fwd expected errors")
        out.append(f"{self.sum_ee2 / self.out_recs:10.2f}"
                   f"  Mean rev expected errors")
        out.append(f"{self.sum_merged_ee / self.out_recs:10.2f}"
                   f"  Mean merged expected errors")
        return out


def _int_str(n: int) -> str:
    """IntToStr (src/myutils.cpp:~700)."""
    if n < 10000:
        return str(n)
    if n < 1e6:
        return f"{n / 1e3:.1f}k"
    if n < 100e6:
        return f"{n / 1e6:.1f}M"
    if n < 1e9:
        return f"{n / 1e6:.0f}M"
    if n < 10e9:
        return f"{n / 1e9:.1f}G"
    if n < 100e9:
        return f"{n / 1e9:.0f}G"
    return f"{float(n):.3g}"


_merge_mx_cache = None


def _merge_subst_mx():
    global _merge_mx_cache
    if _merge_mx_cache is None:
        from ..scoring import AlnParams
        _merge_mx_cache = AlnParams.from_cmdline(True).subst_mx
    return _merge_mx_cache


def merge_pair(seq1, qual1, seq2, qual2, hf: HSPFinder, ah: AlnHeuristics,
               fq, stats: "MergeStats" = None, f_aln=None,
               labels=("", "")):
    """Returns (merged_seq, merged_qual, hsp, diff_count) or (None, reason).
    seq2 is the raw reverse read (revcomp applied here)."""
    o = options()
    s2rc = revcomp(seq2)
    q2rc = qual2[::-1]
    hf.set_a(seq1)
    hf.set_b(s2rc)
    hsps = hf.ungapped_blast(ah.xdrop_global_hsp, True,
                             ah.min_global_hsp_length,
                             ah.min_global_hsp_score)
    top = None
    for h in hsps:
        if top is None or h.score > top.score:
            top = h
    if top is None:
        if stats:
            stats.notaligned += 1
        return None, "notaligned"
    loi, loj, length = _extend_hsp(len(seq1), len(s2rc), top.loi, top.loj)

    # GetMergeAln left/right/stagger (src/mergealign.cpp:139-172)
    hii = loi + length - 1
    hij = loj + length - 1
    fl, rl = len(seq1), len(s2rc)
    left = loi if loj == 0 else -loj
    right = (rl - hij - 1) if hii + 1 == fl else -(rl - hij - 1)
    if length < o.uns("fastq_minovlen"):
        if stats:
            stats.ovtooshort += 1
        return None, "ovtooshort"
    stag = left < 0 or right < 0
    if stats and stag:
        stats.staggered += 1
    if o.flag("fastq_nostagger") and stag:
        return None, "staggered"

    if f_aln is not None:
        # -alnout: local ungapped AR over the overlap
        # (src/mergealign.cpp:268-282 + alnout.cpp WriteAln)
        from ..align.result import AlignResult
        from ..out.alnout import write_aln
        ar = AlignResult(query_label=labels[0], target_label=labels[1],
                         query_seq=seq1, target_seq=s2rc,
                         path="M" * length, nucleo=True, local=True,
                         loi=loi, loj=loj, target_revcomp=True)
        ar.leni_local = length
        ar.lenj_local = length
        mx = _merge_subst_mx()
        raw = 0.0
        for k in range(length):
            raw += float(mx[seq1[loi + k], s2rc[loj + k]])
        ar.raw_score = raw
        write_aln(f_aln, ar)
        if stag:
            # WriteStagger (src/mergealign.cpp:169-203); note the
            # reference prints the FWD read for the Rev row too
            fwd_lo = hii - 10 if hii > 10 else 0
            fwd_hi = len(seq1) - 1
            rev_hi = min(loj + 10, len(s2rc) - 1)
            f_aln.write("Staggered\n")
            f_aln.write("Fwd trim %u-%u: " % (fwd_lo, fwd_hi))
            f_aln.write(seq1[fwd_lo:fwd_hi + 1].tobytes().decode("latin1"))
            f_aln.write("\n")
            f_aln.write("Rev trim %u-%u: " % (0, rev_hi))
            f_aln.write(seq1[0:rev_hi + 1].tobytes().decode("latin1"))
            f_aln.write("\n")

    # MergeSI (src/mergealign.cpp:44-123)
    out_seq = []
    out_qual = []
    pos1 = 0
    for i in range(loi):
        out_seq.append(seq1[pos1])
        out_qual.append(qual1[pos1])
        pos1 += 1
    pos2 = loj
    diff_count = 0
    pm = fq.pair_match_int
    pmm = fq.pair_mismatch_int
    for _k in range(length):
        c1, c2 = seq1[pos1], s2rc[pos2]
        q1, q2 = ord(qual1[pos1]), ord(q2rc[pos2])
        iq1, iq2 = fq.char_to_int(q1), fq.char_to_int(q2)
        if c1 == c2:
            out_seq.append(c1)
            out_qual.append(chr(fq.int_to_char(pm[iq1, iq2])))
        else:
            diff_count += 1
            out_seq.append(c1 if q1 >= q2 else c2)
            out_qual.append(chr(fq.int_to_char(pmm[iq1, iq2])))
        pos1 += 1
        pos2 += 1
    while pos2 < rl:
        out_seq.append(s2rc[pos2])
        out_qual.append(q2rc[pos2])
        pos2 += 1

    if stats and diff_count == 0:
        stats.exact += 1
    if diff_count > o.uns("fastq_maxdiffs"):
        if stats:
            stats.maxdiffs += 1
        return None, "maxdiffs"
    pct_id = 100.0 * (length - diff_count) / length if length else 0.0
    if pct_id < float(o.uns("fastq_pctid")):
        if stats:
            stats.maxdiffs += 1
        return None, "pctid"

    mseq = np.array(out_seq, dtype=np.uint8)
    mqual = "".join(out_qual)

    # MergePost gates
    if o.filled("fastq_minmergelen") and len(mseq) < o.uns("fastq_minmergelen"):
        if stats:
            stats.merged_tooshort += 1
        return None, "tooshort"
    if o.filled("fastq_maxmergelen") and len(mseq) > o.uns("fastq_maxmergelen"):
        if stats:
            stats.merged_toolong += 1
        return None, "toolong"
    if o.filled("fastq_minqual"):
        minq = min(fq.char_to_int(ord(q)) for q in mqual)
        if minq < o.uns("fastq_minqual"):
            if stats:
                stats.minq += 1
            return None, "minq"
    return (mseq, mqual, (loi, loj, length), diff_count), None


def _native_merge_ctx(ap, ah, fq):
    """Build the merge_pair_c call context, or None without the lib."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    from ..alpha import CHAR_TO_LETTER_NUCLEO, CHAR_TO_COMP_CHAR
    o = options()
    mx = np.ascontiguousarray(ap.subst_mx, dtype=np.float32)
    ctl = np.ascontiguousarray(CHAR_TO_LETTER_NUCLEO)
    comp = np.ascontiguousarray(CHAR_TO_COMP_CHAR)
    hf = lib.hsp_create(ah.hsp_word_length, 4, mx, ctl)
    es = lib.engine_scratch_create()
    pm = np.ascontiguousarray(fq.pair_match_int)
    pmm = np.ascontiguousarray(fq.pair_mismatch_int)
    cap = 1 << 16
    out_seq = np.empty(cap, np.uint8)
    out_qual = np.empty(cap, np.uint8)
    meta = np.zeros(8, np.int64)
    args = dict(
        lib=lib, hf=hf, es=es, comp=comp, pm=pm, pmm=pmm,
        out_seq=out_seq, out_qual=out_qual, meta=meta, cap=cap,
        keep=(mx, ctl),
        xdrop=float(ah.xdrop_global_hsp),
        min_hsp_len=int(ah.min_global_hsp_length),
        min_hsp_score=float(ah.min_global_hsp_score),
        minovlen=o.uns("fastq_minovlen"),
        nostagger=int(o.flag("fastq_nostagger")),
        maxdiffs=o.uns("fastq_maxdiffs"),
        pctid=float(o.uns("fastq_pctid")),
        minmergelen=(o.uns("fastq_minmergelen")
                     if o.filled("fastq_minmergelen") else 0),
        maxmergelen=(o.uns("fastq_maxmergelen")
                     if o.filled("fastq_maxmergelen") else 0),
        minqual=(o.uns("fastq_minqual")
                 if o.filled("fastq_minqual") else -1),
        base=fq.base)
    return args


def _merge_pair_native(nat, s1, q1, s2, q2, stats):
    """merge_pair via merge_pair_c; stats counters mirror merge_pair."""
    lib = nat["lib"]
    if len(s1) + len(s2) + 2 > nat["cap"]:
        nat["cap"] = 2 * (len(s1) + len(s2) + 2)
        nat["out_seq"] = np.empty(nat["cap"], np.uint8)
        nat["out_qual"] = np.empty(nat["cap"], np.uint8)
    meta = nat["meta"]
    s1c = s1 if s1.flags["C_CONTIGUOUS"] else np.ascontiguousarray(s1)
    s2c = s2 if s2.flags["C_CONTIGUOUS"] else np.ascontiguousarray(s2)
    status = lib.merge_pair_c(
        nat["hf"], nat["es"],
        s1c.ctypes.data, len(s1c), q1.encode("latin1"),
        s2c.ctypes.data, len(s2c), q2.encode("latin1"),
        nat["comp"].ctypes.data,
        nat["xdrop"], nat["min_hsp_len"], nat["min_hsp_score"],
        nat["minovlen"], nat["nostagger"], nat["maxdiffs"], nat["pctid"],
        nat["minmergelen"], nat["maxmergelen"], nat["minqual"],
        nat["base"],
        nat["pm"].ctypes.data, nat["pmm"].ctypes.data,
        nat["out_seq"].ctypes.data, nat["out_qual"].ctypes.data,
        meta.ctypes.data)
    if stats:
        if status == 1:
            stats.notaligned += 1
        elif status == 2:
            stats.ovtooshort += 1
        else:
            if meta[6]:
                stats.staggered += 1
            if status != 3 and meta[4] == 0:
                stats.exact += 1
            if status in (4, 5):
                stats.maxdiffs += 1
            elif status == 6:
                stats.merged_tooshort += 1
            elif status == 7:
                stats.merged_toolong += 1
            elif status == 8:
                stats.minq += 1
    if status != 0:
        return None
    outn = int(meta[5])
    mseq = nat["out_seq"][:outn].copy()
    mqual = nat["out_qual"][:outn].tobytes().decode("latin1")
    return (mseq, mqual, (int(meta[1]), int(meta[2]), int(meta[3])),
            int(meta[4]))


def _merge_files_native(nat, fwd_path, rev_path, fq, stats, f_fq,
                        f_rep) -> bool:
    """Whole-file merge via merge_files_c.  Returns False to fall back
    to the Python loop (parse error / label mismatch diagnostics)."""
    o = options()
    lib = nat["lib"]
    from ..io.fastx import open_maybe_gz
    with open_maybe_gz(fwd_path) as f:
        fwd = f.read()
    with open_maybe_gz(rev_path) as f:
        rev = f.read()
    rl = Relabeler(fwd_path)
    prefix = rl.prefix.encode("latin1")
    minlen = o.uns("fastq_minlen") if o.filled("fastq_minlen") else -1
    si = np.zeros(16, np.int64)
    sf = np.zeros(8, np.float64)
    out_len = np.zeros(1, np.int64)
    ml_cap = len(fwd) // 8 + 16
    mlens = np.empty(ml_cap, np.int32)
    # streaming output: the C loop writes the fd in 4MB chunks so the
    # kernel's async writeback overlaps merge compute (one end-of-run
    # ~100MB write serializes compute + disk and cost ~0.25x of the
    # whole command on a ~75MB/s disk); buffer only needs chunk + one
    # record of headroom
    out_fd = -1
    fd_pos0 = 0
    if f_fq is not None:
        f_fq.flush()
        out_fd = f_fq.buffer.fileno()
        fd_pos0 = os.lseek(out_fd, 0, os.SEEK_CUR)
        cap = (8 << 20)
    else:
        cap = len(fwd) + len(rev) + 1024
    ctp = fq._ctp_c()
    while True:
        out_buf = np.empty(cap, np.uint8)
        si[:] = 0
        sf[:] = 0
        if out_fd >= 0:
            # grow-retry / python-fallback must not duplicate already-
            # streamed records
            os.lseek(out_fd, fd_pos0, os.SEEK_SET)
            os.ftruncate(out_fd, fd_pos0)
        n = lib.merge_files_c(
            nat["hf"], nat["es"],
            fwd, len(fwd), rev, len(rev),
            nat["comp"].ctypes.data, ctp.ctypes.data,
            nat["xdrop"], nat["min_hsp_len"], nat["min_hsp_score"],
            nat["minovlen"], nat["nostagger"], nat["maxdiffs"],
            nat["pctid"],
            nat["minmergelen"], nat["maxmergelen"], nat["minqual"],
            nat["base"], o.uns("fastq_trunctail"), o.uns("fastq_tail"),
            minlen,
            int(o.flag("ignore_label_mismatches")),
            prefix, len(prefix),
            nat["pm"].ctypes.data, nat["pmm"].ctypes.data,
            out_buf.ctypes.data, cap, out_len.ctypes.data,
            out_fd,
            mlens.ctypes.data, si.ctypes.data, sf.ctypes.data)
        if n == -3:
            cap *= 2
            continue
        if n < 0:
            if out_fd >= 0:
                os.lseek(out_fd, fd_pos0, os.SEEK_SET)
                os.ftruncate(out_fd, fd_pos0)
            return False     # python loop reproduces exact diagnostics
        break
    (stats.in_recs, stats.out_recs, stats.tail1, stats.tail2,
     stats.tooshort1, stats.tooshort2, stats.notaligned,
     stats.ovtooshort, stats.staggered, stats.exact, stats.maxdiffs,
     stats.minq, stats.merged_tooshort, stats.merged_toolong
     ) = (int(v) for v in si[:14])
    stats.sum_ee1 = float(sf[0])
    stats.sum_ee2 = float(sf[1])
    stats.sum_merged_ee = float(sf[2])
    stats.sum_ov_length = float(sf[3])
    stats.sum_merged_length = float(sf[4])
    if f_fq is not None and out_fd < 0:
        f_fq.flush()
        f_fq.buffer.write(out_buf[:int(out_len[0])].tobytes())
    if f_rep:
        stats.merge_lengths = mlens[:stats.out_recs].tolist()

        def _pct(a, d):
            return 0.0 if d == 0 else 100.0 * a / d
        f_rep.write(f"  {stats.out_recs} / {stats.in_recs} pairs merged"
                    f" ({_pct(stats.out_recs, stats.in_recs):.1f}%)\n")
        for s in stats.report_strs():
            f_rep.write(s + "\n")
        f_rep.close()
    return True


def fastq_mergepairs(fwd_path: Optional[str]) -> None:
    o = options()
    # oset_unsd(OPT_fastq_minlen, 64) (src/fastqmerge.cpp:121)
    o.set_default("fastq_minlen", 64)
    if o.filled("fastq_maxee"):
        raise SystemExit("maxee filtering not supported, use fastq_filter")
    rev_path = o.str("reverse")
    if not fwd_path or not rev_path:
        raise SystemExit("Missing input")
    if not o.flag("notrunclabels"):
        o.set("trunclabels", True)

    fq = get_fastq()
    ap = AlnParams.from_cmdline(True)
    ah = AlnHeuristics.from_cmdline(ap)
    hf = HSPFinder(ap, ah)
    rl = Relabeler(fwd_path)

    f_fq = open(o.str("fastqout"), "w") if o.filled("fastqout") else None
    f_fa = open(o.str("fastaout"), "w") if o.filled("fastaout") else None
    f_nm_fwd_fq = open(o.str("fastqout_notmerged_fwd"), "w") \
        if o.filled("fastqout_notmerged_fwd") else None
    f_nm_rev_fq = open(o.str("fastqout_notmerged_rev"), "w") \
        if o.filled("fastqout_notmerged_rev") else None
    f_nm_fwd_fa = open(o.str("fastaout_notmerged_fwd"), "w") \
        if o.filled("fastaout_notmerged_fwd") else None
    f_nm_rev_fa = open(o.str("fastaout_notmerged_rev"), "w") \
        if o.filled("fastaout_notmerged_rev") else None

    f_rep = open(o.str("report"), "w") if o.filled("report") else None
    f_aln = open(o.str("alnout"), "w") if o.filled("alnout") else None
    # -eetabbedout is opened but never written by the reference merger
    # (src/fastqmerge.cpp:146-147,201) => empty file
    f_ee = open(o.str("eetabbedout"), "w") \
        if o.filled("eetabbedout") else None
    stats = MergeStats()
    if f_rep:
        # src/fastqmerge.cpp:54-68
        f_rep.write("\nMerge\n")
        f_rep.write(f"  Fwd {fwd_path}\n")
        f_rep.write(f"  Rev {rev_path}\n")
        if o.filled("relabel"):
            f_rep.write(f"  Relabel with {o.str('relabel')}#")
        else:
            f_rep.write("  Keep read labels")
        if o.filled("sample"):
            f_rep.write(f",  add sample={o.str('sample')};")
        f_rep.write("\n")

    # whole-file native loop (merge_files_c): parse + MergePre + merge +
    # stats + output formatting all in C when no option needs the
    # per-record Python path
    fast_ok = (f_aln is None and f_fa is None and f_nm_fwd_fq is None
               and f_nm_rev_fq is None and f_nm_fwd_fa is None
               and f_nm_rev_fa is None and not o.filled("sample")
               and not o.flag("fastq_eeout")
               and not (o.filled("label_suffix")
                        and o.str("label_suffix"))
               and o.flag("trunclabels"))
    if fast_ok:
        nat = _native_merge_ctx(ap, ah, fq)
        if nat is not None and _merge_files_native(
                nat, fwd_path, rev_path, fq, stats, f_fq, f_rep):
            for f in (f_fq, f_fa, f_ee):
                if f:
                    f.close()
            return

    it1 = read_fastq(fwd_path)
    it2 = read_fastq(rev_path)
    trunc = o.flag("trunclabels")
    minlen_filled = o.filled("fastq_minlen")
    minlen = o.uns("fastq_minlen") if minlen_filled else 0

    # native per-pair kernel (merge_pair_c): used unless -alnout needs
    # the Python path's alignment report
    nat = None
    if f_aln is None:
        nat = _native_merge_ctx(ap, ah, fq)

    for (l1, s1, q1), (l2, s2, q2) in zip(it1, it2):
        if trunc:
            l1, l2 = trunc_label(l1), trunc_label(l2)
        if not illumina_label_pair_match(l1, l2):
            raise SystemExit(f"Label mismatch: {l1} vs {l2}")
        orig = (s1, q1, s2, q2)
        stats.in_recs += 1
        # MergePre: tail truncation + minlen, fwd first (src/mergepair.cpp)
        result = None
        ok = True
        s1t, q1t = _truncate_tail(s1, q1, fq)
        if len(s1t) < len(s1):
            stats.tail1 += 1
        if minlen_filled and len(s1t) < minlen:
            stats.tooshort1 += 1
            ok = False
        if ok:
            s2t, q2t = _truncate_tail(s2, q2, fq)
            if len(s2t) < len(s2):
                stats.tail2 += 1
            if minlen_filled and len(s2t) < minlen:
                stats.tooshort2 += 1
                ok = False
        if ok and nat is not None:
            result = _merge_pair_native(nat, s1t, q1t, s2t, q2t, stats)
        elif ok:
            result, _reason = merge_pair(s1t, q1t, s2t, q2t, hf, ah, fq,
                                         stats, f_aln=f_aln,
                                         labels=(l1, l2))
        if result is not None:
            mseq, mqual, _hsp, _d = result
            stats.out_recs += 1
            stats.sum_ee1 += fq.get_ee(q1)
            stats.sum_ee2 += fq.get_ee(q2)
            stats.sum_ov_length += _hsp[2]
            stats.sum_merged_length += len(mseq)
            stats.sum_merged_ee += fq.get_ee(mqual)
            if f_rep:
                stats.merge_lengths.append(len(mseq))
            label = rl.relabel(l1, fq.get_ee(mqual)
                               if o.flag("fastq_eeout") else None)
            if f_fa:
                write_fasta(f_fa, label, mseq, o.uns("fasta_cols"))
            if f_fq:
                write_fastq(f_fq, label, mseq, mqual)
        else:
            # notmerged outputs restore original (untrimmed) reads;
            # SeqInfo::ToFastq/ToFasta skip zero-length sequences
            if f_nm_fwd_fq and len(orig[0]):
                write_fastq(f_nm_fwd_fq, l1, orig[0], orig[1])
            if f_nm_rev_fq and len(orig[2]):
                write_fastq(f_nm_rev_fq, l2, orig[2], orig[3])
            if f_nm_fwd_fa and len(orig[0]):
                write_fasta(f_nm_fwd_fa, l1, orig[0], o.uns("fasta_cols"))
            if f_nm_rev_fa and len(orig[2]):
                write_fasta(f_nm_rev_fa, l2, orig[2], o.uns("fasta_cols"))

    if f_rep:
        # per-file pair summary then global stats (src/fastqmerge.cpp:88-95,
        # :188-196)
        def _pct(n, d):
            return 0.0 if d == 0 else 100.0 * n / d
        f_rep.write(f"  {stats.out_recs} / {stats.in_recs} pairs merged"
                    f" ({_pct(stats.out_recs, stats.in_recs):.1f}%)\n")
        for s in stats.report_strs():
            f_rep.write(s + "\n")
        f_rep.close()

    for f in (f_fq, f_fa, f_nm_fwd_fq, f_nm_rev_fq, f_nm_fwd_fa,
              f_nm_rev_fa, f_aln, f_ee):
        if f:
            f.close()
