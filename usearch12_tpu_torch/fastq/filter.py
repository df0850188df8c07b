"""fastq_filter / fastx_truncate (src/fastqfilter.cpp, src/fastxtruncate.cpp).

Per-read trimming pipeline applied in the reference's exact order:
truncqual, trunctail, stripleft, stripright, maxns, minlen, trunclen,
minqual, maxee/maxee_rate.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import options
from ..io.fastx import read_fastx, write_fasta, write_fastq
from .qual import get_fastq

FF_GOOD, FF_SHORT, FF_HIGH_ERR, FF_MINQ, FF_MAXNS = range(5)


def _filter_one(seq: np.ndarray, qual: str, fq) -> Tuple[int, np.ndarray, str]:
    o = options()
    L = len(seq)
    if L == 0:
        return FF_SHORT, seq, qual

    if o.filled("fastq_truncqual"):
        tq = o.uns("fastq_truncqual")
        for i, q in enumerate(qual):
            if fq.char_to_int(ord(q)) <= tq:
                seq, qual = seq[:i], qual[:i]
                break

    if o.filled("fastq_trunctail"):
        tt = o.uns("fastq_trunctail")
        tail = 0
        for k in range(len(seq)):
            if fq.char_to_int(ord(qual[len(seq) - k - 1])) <= tt:
                tail += 1
            else:
                break
        if tail > 0 and tail > o.uns("fastq_tail"):
            seq, qual = seq[:len(seq) - tail], qual[:len(seq) - tail]

    if o.filled("fastq_stripleft"):
        n = o.uns("fastq_stripleft")
        if len(seq) <= n:
            return FF_SHORT, seq, qual
        seq, qual = seq[n:], qual[n:]

    if o.filled("fastq_stripright"):
        n = o.uns("fastq_stripright")
        if len(seq) <= n:
            return FF_SHORT, seq, qual
        seq, qual = seq[:len(seq) - n], qual[:len(seq) - n]

    if o.filled("fastq_maxns"):
        ncount = int((seq == ord("N")).sum() + (seq == ord("n")).sum())
        if ncount > o.uns("fastq_maxns"):
            return FF_MAXNS, seq, qual

    L = len(seq)
    if L == 0:
        return FF_SHORT, seq, qual
    if o.filled("fastq_minlen") and L < o.uns("fastq_minlen"):
        return FF_SHORT, seq, qual
    if o.filled("fastq_trunclen"):
        tl = o.uns("fastq_trunclen")
        if L < tl:
            return FF_SHORT, seq, qual
        seq, qual = seq[:tl], qual[:tl]
    if o.filled("fastq_minqual"):
        minq = min(fq.char_to_int(ord(q)) for q in qual) if qual else 0
        if minq < o.uns("fastq_minqual"):
            return FF_MINQ, seq, qual
    if o.filled("fastq_maxee") or o.filled("fastq_maxee_rate"):
        ee = fq.get_ee(qual)
        if o.filled("fastq_maxee") and ee > o.flt("fastq_maxee"):
            return FF_HIGH_ERR, seq, qual
        if o.filled("fastq_maxee_rate") and \
                ee > o.flt("fastq_maxee_rate") * len(seq):
            return FF_HIGH_ERR, seq, qual
    return FF_GOOD, seq, qual


class Relabeler:
    """InitFastqRelabel/FastqRelabel (src/mergethread.cpp)."""

    def __init__(self, input_filename: str = "") -> None:
        o = options()
        self.prefix = o.str("relabel", "")
        if self.prefix == "@":
            # sample name from Illumina file name (src/mergethread.cpp:75-91)
            import os
            name = os.path.basename(input_filename)
            n = name.find("_")
            if n < 0:
                n = name.find(".")
            self.prefix = (name if n < 0 else name[:n]) + "."
        elif self.prefix == "-":
            self.prefix = ""
        self.sample = o.str("sample", "") if o.filled("sample") else ""
        self.suffix = o.str("label_suffix", "")
        self.counter = 0

    def relabel(self, label: str, ee: Optional[float] = None) -> str:
        self.counter += 1
        if self.prefix:
            label = f"{self.prefix}{self.counter}"
        o = options()
        if o.filled("sample"):
            if not label.endswith(";"):
                label += ";"
            label += f"sample={self.sample};"
        if o.flag("fastq_eeout") and ee is not None:
            if not label.endswith(";"):
                label += ";"
            label += "ee=%.2g;" % ee
        if self.suffix:
            label += self.suffix
        return label


def _filter_files_native(input_path, fq, rl, f_fq, f_fa, f_disc_fq,
                         f_disc_fa) -> bool:
    """fastq_filter via filter_files_c; False falls back to the Python
    loop (non-FASTQ input or parse errors keep their exact messages)."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return False
    from ..io.fastx import open_maybe_gz, sniff_format
    o = options()
    if sniff_format(input_path) != "fastq":
        return False
    with open_maybe_gz(input_path) as f:
        buf = f.read()

    def u(name):
        return o.uns(name) if o.filled(name) else -1
    maxee = o.flt("fastq_maxee") if o.filled("fastq_maxee") else -1.0
    maxee_rate = o.flt("fastq_maxee_rate") \
        if o.filled("fastq_maxee_rate") else -1.0
    prefix = rl.prefix.encode("latin1")
    lens = np.zeros(4, np.int64)
    cap = len(buf) + 1024 + (len(prefix) + 24) * (len(buf) // 8 + 1)
    while True:
        bufs = [np.empty(cap if f else 1, np.uint8)
                for f in (f_fq, f_fa, f_disc_fq, f_disc_fa)]
        n = lib.filter_files_c(
            buf, len(buf), fq.base,
            u("fastq_truncqual"), u("fastq_trunctail"),
            o.uns("fastq_tail"),
            u("fastq_stripleft"), u("fastq_stripright"),
            u("fastq_maxns"),
            u("fastq_minlen"), u("fastq_trunclen"), u("fastq_minqual"),
            maxee, maxee_rate, fq._ctp_c().ctypes.data,
            int(o.flag("trunclabels")), prefix, len(prefix),
            o.uns("fasta_cols"),
            bufs[0].ctypes.data if f_fq else None,
            cap if f_fq else 0, lens[0:1].ctypes.data,
            bufs[1].ctypes.data if f_fa else None,
            cap if f_fa else 0, lens[1:2].ctypes.data,
            bufs[2].ctypes.data if f_disc_fq else None,
            cap if f_disc_fq else 0, lens[2:3].ctypes.data,
            bufs[3].ctypes.data if f_disc_fa else None,
            cap if f_disc_fa else 0, lens[3:4].ctypes.data)
        if n == -3:
            cap *= 2
            continue
        if n < 0:
            return False
        break
    for f, b, ln in zip((f_fq, f_fa, f_disc_fq, f_disc_fa), bufs,
                        lens.tolist()):
        if f is not None:
            f.flush()
            f.buffer.write(b[:int(ln)].tobytes())
    return True


def fastq_filter(input_path: Optional[str]) -> None:
    o = options()
    if not input_path:
        raise SystemExit("Missing input")
    fq = get_fastq()
    rl = Relabeler(input_path)

    f_fq = open(o.str("fastqout"), "w") if o.filled("fastqout") else None
    f_fa = open(o.str("fastaout"), "w") if o.filled("fastaout") else None
    f_disc_fa = open(o.str("fastaout_discarded"), "w") \
        if o.filled("fastaout_discarded") else None
    f_disc_fq = open(o.str("fastqout_discarded"), "w") \
        if o.filled("fastqout_discarded") else None
    f_ee = open(o.str("eetabbedout"), "w") if o.filled("eetabbedout") \
        else None

    # whole-file native loop (filter_files_c) for the common option set
    if (f_ee is None and not o.flag("fastq_eeout")
            and not o.filled("sample")
            and not (o.filled("label_suffix") and o.str("label_suffix"))
            and _filter_files_native(input_path, fq, rl, f_fq, f_fa,
                                     f_disc_fq, f_disc_fa)):
        for f in (f_fq, f_fa, f_disc_fa, f_disc_fq):
            if f:
                f.close()
        return

    for label, seq, qual in read_fastx(input_path):
        if qual is None:
            raise SystemExit("fastq_filter requires FASTQ input")
        ff, seq2, qual2 = _filter_one(seq, qual, fq)
        # SeqInfo::ToFastq/ToFasta skip zero-length sequences
        if ff == FF_GOOD:
            ee = fq.get_ee(qual2) if (o.flag("fastq_eeout") or f_ee) else None
            new_label = rl.relabel(label, ee)
            if f_ee:
                f_ee.write("%s\t%.2g\n" % (label, ee))
            if f_fq and len(seq2):
                write_fastq(f_fq, new_label, seq2, qual2)
            if f_fa and len(seq2):
                write_fasta(f_fa, new_label, seq2, o.uns("fasta_cols"))
        else:
            if f_disc_fq and len(seq2):
                write_fastq(f_disc_fq, label, seq2, qual2)
            if f_disc_fa and len(seq2):
                write_fasta(f_disc_fa, label, seq2, o.uns("fasta_cols"))

    for f in (f_fq, f_fa, f_disc_fa, f_disc_fq, f_ee):
        if f:
            f.close()


def _truncate_files_native(input_path) -> bool:
    """fastx_truncate via truncate_files_c (FASTQ input)."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return False
    from ..io.fastx import open_maybe_gz, sniff_format
    o = options()
    if sniff_format(input_path) != "fastq":
        return False
    with open_maybe_gz(input_path) as f:
        buf = f.read()
    relabel_mode = 0
    relabel = b""
    r = o.str("relabel", "")
    if r:
        relabel_mode = 2 if r.startswith("+") else 1
        relabel = r.encode("latin1")
    elif o.filled("label_suffix") and o.str("label_suffix"):
        relabel_mode = 3
        relabel = o.str("label_suffix").encode("latin1")
    padq = (o.str("padq") if o.filled("padq") else "I")[0]
    f_fa = open(o.str("fastaout"), "w") if o.filled("fastaout") else None
    f_fq = open(o.str("fastqout"), "w") if o.filled("fastqout") else None
    lens = np.zeros(2, np.int64)
    cap = len(buf) + 1024 + (len(relabel) + 32) * (len(buf) // 8 + 1) \
        + (o.uns("padlen") + 4) * (len(buf) // 8 + 1)
    while True:
        bq = np.empty(cap if f_fq else 1, np.uint8)
        ba = np.empty(cap if f_fa else 1, np.uint8)
        n = lib.truncate_files_c(
            buf, len(buf),
            o.uns("stripleft"), o.uns("stripright"),
            o.uns("padlen"), ord(padq),
            o.uns("trunclen"),
            o.uns("minseqlength") if o.filled("minseqlength") else -1,
            o.uns("maxseqlength") if o.filled("maxseqlength") else -1,
            int(o.flag("trunclabels")),
            relabel_mode, relabel, len(relabel),
            o.uns("fasta_cols"),
            bq.ctypes.data if f_fq else None, cap if f_fq else 0,
            lens[0:1].ctypes.data,
            ba.ctypes.data if f_fa else None, cap if f_fa else 0,
            lens[1:2].ctypes.data)
        if n == -3:
            cap *= 2
            continue
        if n < 0:
            for f in (f_fa, f_fq):
                if f:
                    f.close()
            return False
        break
    for f, b, ln in zip((f_fq, f_fa), (bq, ba), lens.tolist()):
        if f is not None:
            f.flush()
            f.buffer.write(b[:int(ln)].tobytes())
            f.close()
    from .. import progress
    progress.start("Filtering")
    progress.done(f"{n} reads")
    return True


def fastx_truncate(input_path: Optional[str]) -> None:
    """cmd_fastx_truncate (src/fastxtruncate.cpp): -trunclen/-stripleft/
    -stripright + -padlen.  The reference reads all four with oget_uns
    up front (fastxtruncate.cpp:47-50), so each is REQUIRED (quirk)."""
    o = options()
    for name in ("padlen", "trunclen", "stripleft", "stripright"):
        if not o.filled(name):
            raise SystemExit(f"Required option not set -{name}")
    if _truncate_files_native(input_path):
        return
    f_fa = open(o.str("fastaout"), "w") if o.filled("fastaout") else None
    f_fq = open(o.str("fastqout"), "w") if o.filled("fastqout") else None
    relabel = o.str("relabel", "")
    n_out = 0
    from .. import progress
    progress.start("Filtering")
    n_rec = 0
    for label, seq, qual in read_fastx(input_path, stream=True):
        n_rec += 1
        progress.tick(n_rec, 0)
        if o.filled("stripleft"):
            n = o.uns("stripleft")
            if len(seq) <= n:
                continue
            seq = seq[n:]
            qual = qual[n:] if qual else qual
        if o.filled("stripright"):
            n = o.uns("stripright")
            if len(seq) <= n:
                continue
            seq = seq[:len(seq) - n]
            qual = qual[:len(seq)] if qual else qual
        if o.filled("padlen"):
            pl = o.uns("padlen")
            padq = o.str("padq") if o.filled("padq") else "I"
            if len(seq) < pl:
                pad = pl - len(seq)
                seq = np.concatenate(
                    [seq, np.full(pad, ord("N"), dtype=np.uint8)])
                if qual:
                    qual = qual + padq * pad
        if o.filled("trunclen"):
            tl = o.uns("trunclen")
            if len(seq) < tl:
                continue
            seq = seq[:tl]
            qual = qual[:tl] if qual else qual
        if o.filled("minseqlength") and len(seq) < o.uns("minseqlength"):
            continue
        if o.filled("maxseqlength") and len(seq) > o.uns("maxseqlength"):
            continue
        n_out += 1
        if relabel:
            if relabel.startswith("+"):
                label = f"{label}{relabel}{n_out}"
            else:
                label = f"{relabel}{n_out}"
        elif o.filled("label_suffix"):
            label += o.str("label_suffix")
        if f_fa:
            write_fasta(f_fa, label, seq, o.uns("fasta_cols"))
        if f_fq and qual is not None:
            write_fastq(f_fq, label, seq, qual)
    for f in (f_fa, f_fq):
        if f:
            f.close()


    progress.done(f"{n_rec} reads")

def fastq_filter2(input_path: Optional[str]) -> None:
    """fastq_filter2 (src/fastqfilter2.cpp): paired EE + zero-N filter
    keeping R1/R2 in sync."""
    from .qual import get_fastq
    from ..io.fastx import read_fastq
    o = options()
    rev_path = o.str("reverse")
    if not input_path or not rev_path:
        raise SystemExit("Missing input")
    max_ee = o.flt("fastq_maxee") if o.filled("fastq_maxee") else 1.0
    fq = get_fastq()
    f1 = open(o.str("fastqout"), "w") if o.filled("fastqout") else None
    f2 = None
    if f1 is not None:
        if not o.filled("output2"):
            raise SystemExit("-output2 required with -fastqout")
        f2 = open(o.str("output2"), "w")

    from ..native import get_lib
    lib = get_lib()
    if lib is not None and not o.flag("trunclabels"):
        import numpy as np
        from ..io.fastx import open_maybe_gz
        with open_maybe_gz(input_path) as f:
            fwd = f.read()
        with open_maybe_gz(rev_path) as f:
            rev = f.read()
        lens = np.zeros(2, np.int64)
        cap1 = len(fwd) + 64
        cap2 = len(rev) + 64
        b1 = np.empty(cap1 if f1 else 1, np.uint8)
        b2 = np.empty(cap2 if f2 else 1, np.uint8)
        n = lib.filter2_files_c(
            fwd, len(fwd), rev, len(rev),
            float(max_ee), fq._ctp_c().ctypes.data,
            b1.ctypes.data if f1 else None, cap1 if f1 else 0,
            lens[0:1].ctypes.data,
            b2.ctypes.data if f2 else None, cap2 if f2 else 0,
            lens[1:2].ctypes.data)
        if n >= 0:
            for f, b, ln in zip((f1, f2), (b1, b2), lens.tolist()):
                if f is not None:
                    f.flush()
                    f.buffer.write(b[:int(ln)].tobytes())
                    f.close()
            return
    for (l1, s1, q1), (l2, s2, q2) in zip(read_fastq(input_path),
                                          read_fastq(rev_path)):
        ee1 = fq.get_ee(q1)
        ee2 = fq.get_ee(q2)
        n1 = int((s1 == ord("N")).sum() + (s1 == ord("n")).sum())
        n2 = int((s2 == ord("N")).sum() + (s2 == ord("n")).sum())
        if ee1 <= max_ee and ee2 <= max_ee and n1 == 0 and n2 == 0:
            if f1 and len(s1):
                write_fastq(f1, l1, s1, q1)
            if f2 and len(s2):
                write_fastq(f2, l2, s2, q2)
    for f in (f1, f2):
        if f:
            f.close()
