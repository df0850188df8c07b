"""Vectorized sink emitters for the batch engine.

The generic sink path builds AlignResult objects per hit (~75us/query of
Python); when a run's only output is one tabular file, these emitters
format straight from the packed hit arrays.  Field semantics are
identical to the per-AR writers (out/blast6.py, out/uc.py) — parity is
asserted by the test suite running both paths.
"""

from __future__ import annotations

import numpy as np

from ..search.hitmgr import quick_sort_order


def _order_hits(stats_list):
    """Replay the HitMgr output order (QuickSortOrderDesc over float32
    fract-id scores, src/hitmgr.cpp / sort.h:62-101)."""
    n = len(stats_list)
    if n <= 1:
        return range(n)
    scores = [np.float32(s[6] / (s[1] - s[0] + 1)) for s in stats_list]
    if n == 2:
        # Hoare partition with middle pivot: ties put the later hit first
        return (0, 1) if scores[1] < scores[0] else (1, 0)
    return quick_sort_order(scores, desc=True)


class Blast6Emitter:
    """blast6 lines straight from packed hits (out/blast6.py semantics:
    global search => qlo..qhi = 1..LA always, tlo..thi flipped for a
    revcomp query, evalue/bitscore = '*')."""

    def __init__(self, f, db, output_no_hits: bool) -> None:
        self.f = f
        self.db = db
        self.no_hits = output_no_hits
        self._tlabels = db.labels
        self._tlens = [len(s) for s in db.seqs]
        self._packed = None

    def _prep_packed(self):
        """Concatenated target-label bytes for the C emitter."""
        lbls = [lab.encode("latin1") for lab in self._tlabels]
        buf = np.frombuffer(b"".join(lbls), dtype=np.uint8)
        if len(buf) == 0:
            buf = np.zeros(1, np.uint8)
        off = np.zeros(len(lbls) + 1, np.int64)
        np.cumsum([len(x) for x in lbls], out=off[1:])
        tlen = np.array(self._tlens, dtype=np.int64)
        if len(tlen) == 0:
            tlen = np.zeros(1, np.int64)
        self._packed = (np.ascontiguousarray(buf),
                        np.ascontiguousarray(off),
                        np.ascontiguousarray(tlen))
        self._out_cap = 1 << 20

    def emit_packed(self, raw_buf, lbl_off, lbl_end, jobs_per_rec, j_off,
                    hit_job, hit_tix, hit_stats, job_start) -> None:
        """Whole-window C formatting (blast6_emit_c); hit arrays are
        job-sorted, job_start is the per-job prefix."""
        from ..native import get_lib
        import ctypes
        lib = get_lib()
        if self._packed is None:
            self._prep_packed()
        tbuf, toff, tlen = self._packed
        nrec = len(lbl_off)
        lbl_off = np.ascontiguousarray(lbl_off, np.int64)
        lbl_end = np.ascontiguousarray(lbl_end, np.int64)
        j_off = np.ascontiguousarray(j_off, np.int64)
        hit_job = np.ascontiguousarray(hit_job, np.int32)
        hit_tix = np.ascontiguousarray(hit_tix, np.uint32)
        hit_stats = np.ascontiguousarray(hit_stats, np.int64)
        job_start = np.ascontiguousarray(job_start, np.int64)
        while True:
            out = ctypes.create_string_buffer(self._out_cap)
            n = lib.blast6_emit_c(
                raw_buf.ctypes.data, lbl_off.ctypes.data,
                lbl_end.ctypes.data, nrec, jobs_per_rec,
                j_off.ctypes.data,
                hit_job.ctypes.data, hit_tix.ctypes.data,
                hit_stats.ctypes.data, job_start.ctypes.data,
                tbuf.ctypes.data, toff.ctypes.data, tlen.ctypes.data,
                int(self.no_hits), out, self._out_cap)
            if n >= 0:
                break
            self._out_cap *= 4
        self.f.write(out.raw[:n].decode("latin1"))

    def emit(self, label_of, lo, hi, per_job_hits, jobs_per_rec, j_off,
             jbuf) -> None:
        out = []
        ap = out.append
        tl = self._tlabels
        tn = self._tlens
        no_hits = self.no_hits
        fmt = "%s\t%s\t%.1f\t%d\t%d\t%d\t1\t%d\t%d\t%d\t*\t*\n"
        one = jobs_per_rec == 1
        for r in range(hi - lo):
            j0 = r * jobs_per_rec
            if one:
                # common fast path: plus-strand, single job per record
                ph = per_job_hits[j0]
                if not ph:
                    if no_hits:
                        ap(f"{label_of(lo + r)}\t*\t0\t0\t0\t0\t0\t0"
                           "\t0\t0\t*\t0\n")
                    continue
                la = int(j_off[j0 + 1] - j_off[j0])
                label = label_of(lo + r)
                if len(ph) == 1:
                    tix, _path, st = ph[0]
                    alnlen = int(st[1] - st[0] + 1)
                    ap(fmt % (label, tl[tix],
                              100.0 * (int(st[6]) / alnlen), alnlen,
                              int(st[8] - st[6]), int(st[9]), la,
                              1, tn[tix]))
                    continue
                hits = [(tix, st, False, la) for tix, _p, st in ph]
            else:
                hits = []
                for s in range(jobs_per_rec):
                    j = j0 + s
                    la = int(j_off[j + 1] - j_off[j])
                    for tix, _path, st in per_job_hits[j]:
                        hits.append((tix, st, s == 1, la))
                if not hits:
                    if no_hits:
                        ap(f"{label_of(lo + r)}\t*\t0\t0\t0\t0\t0\t0"
                           "\t0\t0\t*\t0\n")
                    continue
                label = label_of(lo + r)
            for k in _order_hits([h[1] for h in hits]):
                tix, st, is_rc, la = hits[k]
                alnlen = int(st[1] - st[0] + 1)
                lb = tn[tix]
                tlo, thi = (lb, 1) if is_rc else (1, lb)
                ap(fmt % (label, tl[tix], 100.0 * (int(st[6]) / alnlen),
                          alnlen, int(st[8] - st[6]), int(st[9]), la,
                          tlo, thi))
        self.f.write("".join(out))
