"""fastq_join: pair concatenation with pad (src/fastqjoin.cpp)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..alpha import revcomp
from ..config import options
from ..io.fastx import read_fastq, write_fasta, write_fastq
from .merge import illumina_label_pair_match, trunc_label


def _join_files_native(fwd_path, rev_path, pad, padq, f_fq, f_fa) -> bool:
    """Whole-file join via join_files_c; False = use the Python loop."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return False
    o = options()
    from ..io.fastx import open_maybe_gz
    from ..alpha import CHAR_TO_COMP_CHAR
    with open_maybe_gz(fwd_path) as f:
        fwd = f.read()
    with open_maybe_gz(rev_path) as f:
        rev = f.read()
    relabel_mode = 0
    relabel = b""
    if o.filled("relabel"):
        r = o.str("relabel")
        if r.startswith("+"):
            relabel_mode = 2
        else:
            relabel_mode = 1
        relabel = r.encode("latin1")
    comp = np.ascontiguousarray(CHAR_TO_COMP_CHAR)
    lens = np.zeros(2, np.int64)
    cap = len(fwd) + len(rev) + 1024 \
        + (len(pad) + len(relabel) + 32) * (len(fwd) // 8 + 1)
    while True:
        bq = np.empty(cap if f_fq else 1, np.uint8)
        ba = np.empty(cap if f_fa else 1, np.uint8)
        n = lib.join_files_c(
            fwd, len(fwd), rev, len(rev), comp.ctypes.data,
            pad.encode("latin1"), len(pad),
            padq.encode("latin1"), len(padq),
            o.uns("stripleft") if o.filled("stripleft") else -1,
            o.uns("stripright") if o.filled("stripright") else -1,
            int(o.flag("trunclabels")),
            int(o.flag("ignore_label_mismatches")),
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
            return False
        break
    for f, b, ln in zip((f_fq, f_fa), (bq, ba), lens.tolist()):
        if f is not None:
            f.flush()
            f.buffer.write(b[:int(ln)].tobytes())
    return True


def fastq_join(fwd_path: Optional[str]) -> None:
    o = options()
    if o.filled("output"):
        raise SystemExit("Use -fastqout and/or -fastaout, not -output")
    rev_path = o.str("reverse")
    if not fwd_path or not rev_path:
        raise SystemExit("Missing filename")

    pad = o.str("join_padgap") if o.filled("join_padgap") else "NNNNNNNN"
    padq = o.str("join_padgapq") if o.filled("join_padgap") else "IIIIIIII"
    if len(padq) != len(pad):
        raise SystemExit("padq length != padgap")
    pad_arr = np.frombuffer(pad.encode(), dtype=np.uint8)

    f_fq = open(o.str("fastqout"), "w") if o.filled("fastqout") else None
    f_fa = open(o.str("fastaout"), "w") if o.filled("fastaout") else None
    trunc = o.flag("trunclabels")

    if _join_files_native(fwd_path, rev_path, pad, padq, f_fq, f_fa):
        for f in (f_fq, f_fa):
            if f:
                f.close()
        return

    count = 0
    for (l1, s1, q1), (l2, s2, q2) in zip(read_fastq(fwd_path),
                                          read_fastq(rev_path)):
        if trunc:
            l1, l2 = trunc_label(l1), trunc_label(l2)
        if not illumina_label_pair_match(l1, l2):
            raise SystemExit(f"Label mismatch: {l1} vs {l2}")
        s2rc = revcomp(s2)
        q2rc = q2[::-1]
        if o.filled("stripleft"):
            n = o.uns("stripleft")
            s1, q1 = s1[n:], q1[n:]
        if o.filled("stripright"):
            n = o.uns("stripright")
            s2rc, q2rc = s2rc[:len(s2rc) - n], q2rc[:len(q2rc) - n]
        jseq = np.concatenate([s1, pad_arr, s2rc])
        jqual = q1 + padq + q2rc
        label = l1
        if o.filled("relabel"):
            count += 1
            rlab = o.str("relabel")
            if rlab.startswith("+"):
                label = label + rlab + str(count)
            else:
                label = rlab + str(count)
        if f_fq:
            write_fastq(f_fq, label, jseq, jqual)
        if f_fa:
            write_fasta(f_fa, label, jseq, o.uns("fasta_cols"))
    for f in (f_fq, f_fa):
        if f:
            f.close()
