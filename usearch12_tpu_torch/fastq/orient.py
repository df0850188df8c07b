"""fastx_orient (src/orient.cpp): orient reads vs a reference UDB by
comparing per-word postings-row sizes for forward vs reverse-complement
words (word vote x8, strand vote x4)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..alpha import revcomp
from ..config import options
from ..io.seqdb import SeqDB
from ..io.fastx import read_fastx, write_fasta, write_fastq
from ..index.udb import UDBIndex, UDBParams


def fastx_orient(query_path: Optional[str]) -> None:
    o = options()
    db = SeqDB.from_fastx(o.str("db"))
    db.mask()
    # SetDefaults_Orient -> SetUTax(12): nt words of length 12
    params = UDBParams.global_usearch(True, word_length=12)
    index = UDBIndex.from_seqdb(db, params)
    sizes = index.sizes

    word_x = o.flt("orient_wordx")
    strand_x = o.flt("orient_strandx")

    f_out = open(o.str("tabbedout"), "w") if o.filled("tabbedout") else None
    f_fa = open(o.str("fastaout"), "w") if o.filled("fastaout") else None
    f_fq = open(o.str("fastqout"), "w") if o.filled("fastqout") else None
    f_not = open(o.str("notmatched"), "w") if o.filled("notmatched") else None

    # native per-read vote (orient_read_c): word extraction + revcomp +
    # float32 row-size comparison in one call
    from ..native import get_lib
    lib = get_lib()
    if (lib is not None and not params.hashed
            and _orient_bulk(query_path, o, lib, params, sizes,
                             word_x, strand_x)):
        return
    nat = None
    if lib is not None and not params.hashed:
        from ..alpha import (CHAR_TO_LETTER_NUCLEO, CHAR_TO_COMP_CHAR,
                             IS_LOWER)
        ctl = CHAR_TO_LETTER_NUCLEO.copy()
        ctl[IS_LOWER] = 0xFF
        ctl = np.ascontiguousarray(ctl)
        comp = np.ascontiguousarray(CHAR_TO_COMP_CHAR)
        sizes_c = np.ascontiguousarray(sizes, dtype=np.int64)
        out2 = np.zeros(2, np.int64)
        nat = (ctl, comp, sizes_c, out2)

    for label, seq, qual in read_fastx(query_path, stream=True):
        if len(seq) == 0:
            continue
        plus_count = minus_count = 0
        if nat is not None:
            ctl, comp, sizes_c, out2 = nat
            sc = seq if seq.flags["C_CONTIGUOUS"] \
                else np.ascontiguousarray(seq)
            lib.orient_read_c(sc.ctypes.data, len(sc), comp.ctypes.data,
                              ctl.ctypes.data, params.word_length,
                              params.alpha_size, sizes_c.ctypes.data,
                              word_x, out2.ctypes.data)
            plus_count, minus_count = int(out2[0]), int(out2[1])
        else:
            rc = revcomp(seq)
            words = params.valid_words(seq)
            words_rc = params.valid_words(rc)
            n = len(words)
            if n == len(words_rc):
                sz = sizes[words].astype(np.float32)
                sz_rc = sizes[words_rc[::-1]].astype(np.float32)
                plus_count = int((sz > sz_rc * word_x).sum())
                minus_count = int((sz_rc > sz * word_x).sum())
        plus = plus_count > minus_count * strand_x
        minus = minus_count > plus_count * strand_x
        if plus:
            c = "+"
            if f_fa:
                write_fasta(f_fa, label, seq, o.uns("fasta_cols"))
            if f_fq and qual is not None:
                write_fastq(f_fq, label, seq, qual)
        elif minus:
            c = "-"
            rc = revcomp(seq)
            if f_fa:
                write_fasta(f_fa, label, rc, o.uns("fasta_cols"))
            if f_fq and qual is not None:
                write_fastq(f_fq, label, rc, qual[::-1])
        else:
            c = "?"
            if f_not:
                if qual is None:
                    write_fasta(f_not, label, seq, o.uns("fasta_cols"))
                else:
                    write_fastq(f_not, label, seq, qual)
        if f_out:
            f_out.write(f"{label}\t{c}\t{plus_count}\t{minus_count}\n")

    for f in (f_out, f_fa, f_fq, f_not):
        if f:
            f.close()


def _orient_bulk(query_path, o, lib, params, sizes, word_x,
                 strand_x) -> bool:
    """Whole-file orient: bulk FASTA parse + one C vote pass + C fasta
    emission.  Returns False (caller streams) for FASTQ input, label
    rewriting, or fastqout (quals unavailable in the bulk path)."""
    import ctypes
    from ..alpha import (CHAR_TO_LETTER_NUCLEO, CHAR_TO_COMP_CHAR,
                         IS_LOWER)
    from ..io.seqdb import SeqDB, _LazyLabels
    if o.filled("fastqout") or o.flag("trunclabels") \
            or o.filled("truncstr"):
        return False
    db_q = SeqDB._from_fasta_bulk(query_path, lazy=True)
    if db_q is None or not isinstance(db_q.labels, _LazyLabels):
        return False
    n = len(db_q)
    ctl = CHAR_TO_LETTER_NUCLEO.copy()
    ctl[IS_LOWER] = 0xFF
    ctl = np.ascontiguousarray(ctl)
    comp = np.ascontiguousarray(CHAR_TO_COMP_CHAR)
    sizes_c = np.ascontiguousarray(sizes, dtype=np.int64)
    seqbuf = db_q._bulk_buf
    soff = db_q._bulk_off
    plus_c = np.empty(n, np.int64)
    minus_c = np.empty(n, np.int64)
    lib.orient_batch_c(seqbuf.ctypes.data, soff.ctypes.data, n,
                       comp.ctypes.data, ctl.ctypes.data,
                       params.word_length, params.alpha_size,
                       sizes_c.ctypes.data, float(word_x),
                       plus_c.ctypes.data, minus_c.ctypes.data)
    plus = plus_c > minus_c * float(strand_x)
    minus = minus_c > plus_c * float(strand_x)
    decision = np.zeros(n, np.int8)
    decision[plus] = 1
    decision[minus & ~plus] = -1
    labels = db_q.labels
    raw = np.frombuffer(labels.raw, dtype=np.uint8)
    lo = np.ascontiguousarray(labels.lo, np.int64)
    hi = np.ascontiguousarray(labels.hi, np.int64)

    def emit(path, mode):
        cols = int(o.uns("fasta_cols"))
        cap = int(seqbuf.size + (hi - lo).sum() + 4 * n
                  + (seqbuf.size // max(cols, 1) + n if cols > 0 else n)
                  + 1024)
        while True:
            out = np.empty(cap, np.uint8)
            ret = lib.orient_fasta_emit_c(
                seqbuf.ctypes.data, soff.ctypes.data,
                raw.ctypes.data, lo.ctypes.data, hi.ctypes.data, n,
                comp.ctypes.data, decision.ctypes.data, mode, cols,
                out.ctypes.data, cap)
            if ret >= 0:
                break
            cap *= 2
        with open(path, "wb") as f:
            f.write(out[:ret].tobytes())

    if o.filled("fastaout"):
        emit(o.str("fastaout"), 0)
    if o.filled("notmatched"):
        emit(o.str("notmatched"), 1)
    if o.filled("tabbedout"):
        with open(o.str("tabbedout"), "w") as f:
            chunks = []
            for r in range(n):
                c = "+" if decision[r] == 1 else \
                    ("-" if decision[r] == -1 else "?")
                chunks.append(f"{labels[r]}\t{c}\t{int(plus_c[r])}\t"
                              f"{int(minus_c[r])}\n")
                if len(chunks) >= 8192:
                    f.write("".join(chunks))
                    chunks = []
            f.write("".join(chunks))
    return True
