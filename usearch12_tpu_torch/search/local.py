"""usearch_local: gapped local search (LocalAligner2 + x-drop kernels).

Python orchestration over the native C x-drop implementation
(native/usearch_native.c local_align_pos): per query a word->positions
dictionary; per target a scan over target words seeding ungapped x-drop
extensions, anchor selection, gapped x-drop extension, E-value gate.

Reference: src/localaligner2.cpp (word dict / KeepAR), src/localmulti.cpp:9-118
(AlignMulti scan loop), src/localaligner.cpp:101-211 (AlignPos),
src/estats.cpp (Karlin-Altschul), src/arscorer.cpp:87-103 (GetRawScore
re-scores the path with AlnParams::ScoreLocalPathIgnoreMask, not the DP
score), src/makedbsearcher.cpp:87-127 (EStats DBSize = (float)letter count,
word length 5 nt / 3 aa with -hspw override).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from ..alpha import CHAR_TO_LETTER_AMINO, CHAR_TO_LETTER_NUCLEO
from ..config import options
from ..align.result import AlignResult
from ..align.hsp import HSP

f32 = np.float32
_LOG2 = float(np.log(2.0))


class EStats:
    """src/estats.cpp — Karlin-Altschul statistics.  All math in double;
    db_size and max_evalue arrive through (float) casts in the reference
    (src/makedbsearcher.cpp:92-98)."""

    def __init__(self, nucleo: bool, db_size: float, max_evalue: float):
        import math
        self.db_size = db_size
        self.max_evalue = max_evalue
        if nucleo:
            self.gapped_lambda, self.ungapped_lambda = 1.280, 1.330
            self.gapped_k, self.ungapped_k = 0.460, 0.621
        else:
            self.gapped_lambda, self.ungapped_lambda = 0.267, 0.311
            self.gapped_k, self.ungapped_k = 0.0410, 0.128
        o = options()
        if o.filled("ka_ungapped_k"):
            self.ungapped_k = o.flt("ka_ungapped_k")
        if o.filled("ka_ungapped_lambda"):
            self.ungapped_lambda = o.flt("ka_ungapped_lambda")
        if o.filled("ka_gapped_k"):
            self.gapped_k = o.flt("ka_gapped_k")
        if o.filled("ka_gapped_lambda"):
            self.gapped_lambda = o.flt("ka_gapped_lambda")
        self.log_gapped_k = math.log(self.gapped_k)
        self.log_ungapped_k = math.log(self.ungapped_k)

    def min_ungapped_raw_score(self, query_length: int) -> float:
        import math
        # C log(0) = -inf (a tiny -evalue underflows the float cast to 0;
        # the reference then accepts nothing) — Python math.log(0) raises,
        # so mirror the C behavior explicitly.
        log_e = math.log(self.max_evalue) if self.max_evalue > 0.0 \
            else -math.inf
        bit = (math.log(self.db_size * query_length) - log_e) / _LOG2
        return (bit * _LOG2 + self.log_ungapped_k) / self.ungapped_lambda

    def raw_to_bit(self, raw: float, gapped: bool = True) -> float:
        lam = self.gapped_lambda if gapped else self.ungapped_lambda
        logk = self.log_gapped_k if gapped else self.log_ungapped_k
        return (raw * lam - logk) / _LOG2

    def raw_to_evalue(self, raw: float, query_length: int,
                      gapped: bool = True) -> float:
        bit = self.raw_to_bit(raw, gapped)
        return (query_length * self.db_size) / (2.0 ** bit)

    @classmethod
    def from_cmdline(cls, nucleo: bool, db) -> "EStats":
        o = options()
        if o.filled("ka_dbsize"):
            db_size = float(f32(o.flt("ka_dbsize")))
        else:
            db_size = float(f32(db.letter_count()))
        return cls(nucleo, db_size, float(f32(o.flt("evalue"))))


def _rolling_words(seq: np.ndarray, w: int, nucleo: bool) -> np.ndarray:
    """Rolling k-mers; wildcards degrade to letter 0 so vector subscripts
    stay position-aligned (src/localaligner2.cpp:100-123)."""
    table = CHAR_TO_LETTER_NUCLEO if nucleo else CHAR_TO_LETTER_AMINO
    alpha = 4 if nucleo else 20
    L = len(seq)
    if L < w:
        return np.zeros(0, dtype=np.int64)
    letters = table[seq].astype(np.int64)
    letters[letters >= alpha] = 0
    n = L - w + 1
    words = np.zeros(n, dtype=np.int64)
    for k in range(w):
        words = words * alpha + letters[k:k + n]
    return words


def score_local_path(q_seg: np.ndarray, t_seg: np.ndarray, path: str,
                     mx: np.ndarray, local_open: float, local_ext: float
                     ) -> float:
    """AlnParams::ScoreLocalPathIgnoreMask (src/alnparams.cpp:447-505):
    M cols score the (case-symmetric) matrix; a gap col scores LocalOpen
    when the previous col was M, else LocalExt (even after the other gap
    state).  Values are all multiples of 0.5 so any f32 summation order is
    exact; we accumulate in f64 and cast."""
    total = 0.0
    qp = tp = 0
    last = "M"
    for c in path:
        if c == "M":
            total += float(mx[q_seg[qp], t_seg[tp]])
            qp += 1
            tp += 1
        elif c == "D":
            total += local_open if last == "M" else local_ext
            qp += 1
        else:
            total += local_open if last == "M" else local_ext
            tp += 1
        last = c
    return float(f32(total))


class LocalAligner2:
    """Query word dictionary + target scan (src/localaligner2.cpp,
    src/localmulti.cpp)."""

    def __init__(self, ap, ah, es: EStats) -> None:
        from ..native import get_lib
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native library required for usearch_local")
        self._bind()
        self.ap = ap
        self.ah = ah
        self.es = es
        self.nucleo = ap.nucleo
        o = options()
        if o.filled("hspw"):
            self.word_length = o.uns("hspw")
        else:
            self.word_length = 5 if ap.nucleo else 3
        self.mx = np.ascontiguousarray(ap.subst_mx, dtype=np.float32)
        self.scratch = self.lib.xd_create()
        self.query_seq = None
        self.query_label = ""
        self.min_ungapped = 0.0
        self._hsp_out = np.zeros(4, dtype=np.uint32)
        self._hsp_ptr = self._hsp_out.ctypes.data
        self._mx_ptr = self.mx.ctypes.data
        self._score = ctypes.c_float(0)
        self._evalue = ctypes.c_double(0)
        self._path_buf = ctypes.create_string_buffer(1 << 20)
        self._tword_cache = {}   # id(target seq) -> (ref, words)

    def _bind(self) -> None:
        lib = self.lib
        if getattr(lib, "_local_bound", False):
            return
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C")
        f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C")
        u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C")
        lib.xd_create.restype = ctypes.c_void_p
        lib.xd_destroy.argtypes = [ctypes.c_void_p]
        lib.score_local_path_c.restype = ctypes.c_double
        lib.score_local_path_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_int64, f32p, ctypes.c_float, ctypes.c_float]
        lib.local_align_pos.restype = ctypes.c_int
        # raw pointers (not ndpointer): this is the per-seed hot call,
        # and ndpointer from_param costs ~10us per call
        lib.local_align_pos.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double), ctypes.c_char_p]
        lib._local_bound = True

    def __del__(self):
        try:
            self.lib.xd_destroy(self.scratch)
        except Exception:
            pass

    def set_query(self, label: str, seq: np.ndarray) -> None:
        """SetQueryImpl (src/localaligner2.cpp:66-155 + localaligner.cpp:
        SetQueryImpl).  No words when QL <= w; positions ascend per word;
        counts are NOT capped (unlike HSPFinder's MaxReps)."""
        self.query_label = label
        self.query_seq = np.ascontiguousarray(seq)
        self.min_ungapped = float(f32(
            self.es.min_ungapped_raw_score(len(seq))))
        # sorted word array + stable position order; lookups via
        # vectorized searchsorted in align_multi (positions ascend per
        # word thanks to the stable argsort)
        if len(seq) > self.word_length:
            if hasattr(self.lib, "local_setq_c"):
                ctl = getattr(self, "_ctl_c", None)
                if ctl is None:
                    ctl = self._ctl_c = np.ascontiguousarray(
                        CHAR_TO_LETTER_NUCLEO if self.nucleo
                        else CHAR_TO_LETTER_AMINO)
                n = len(seq) - self.word_length + 1
                sw = np.empty(n, np.int64)
                order = np.empty(n, np.int64)
                self.lib.local_setq_c(
                    self.query_seq.ctypes.data, len(seq),
                    ctl.ctypes.data, 4 if self.nucleo else 20,
                    self.word_length, sw.ctypes.data, order.ctypes.data)
                self._q_sorted_words = sw
                self._q_pos_order = order
            else:
                words = _rolling_words(seq, self.word_length, self.nucleo)
                order = np.argsort(words, kind="stable")
                self._q_sorted_words = words[order]
                self._q_pos_order = order
        else:
            self._q_sorted_words = np.zeros(0, dtype=np.int64)
            self._q_pos_order = np.zeros(0, dtype=np.int64)

    def _align_pos(self, q_ptr, ql, t_ptr, tl, qpos, tpos, max_evalue):
        need = 2 * (ql + tl) + 16
        if need > len(self._path_buf):
            self._path_buf = ctypes.create_string_buffer(2 * need)
        ok = self.lib.local_align_pos(
            self.scratch, q_ptr, ql, t_ptr, tl, qpos, tpos,
            self._mx_ptr,
            self.ah.xdrop_u, self.ah.xdrop_g,
            self.ap.local_open, self.ap.local_ext,
            self.min_ungapped,
            self.es.gapped_lambda, self.es.log_gapped_k,
            self.es.db_size, max_evalue,
            self._hsp_ptr, ctypes.byref(self._score),
            ctypes.byref(self._evalue), self._path_buf)
        return ok

    def _multi_native(self, t_label, q, ql, t, tl, max_evalue):
        """Whole AlignMulti scan via local_multi_c; None = unavailable
        (no C table or ctl for this alphabet)."""
        lib = self.lib
        if not hasattr(lib, "local_multi_c"):
            return None
        if getattr(self, "_es_scratch", None) is None:
            self._es_scratch = lib.engine_scratch_create()
            self._ctl_c = np.ascontiguousarray(
                CHAR_TO_LETTER_NUCLEO if self.nucleo
                else CHAR_TO_LETTER_AMINO)
            self._mh_cap = 64
            self._mh_hsp = np.empty(self._mh_cap * 4, np.int32)
            self._mh_raw = np.empty(self._mh_cap, np.float64)
            self._mh_poff = np.empty(self._mh_cap + 1, np.int64)
            self._mh_pcap = 1 << 16
            self._mh_paths = np.empty(self._mh_pcap, np.uint8)
        sw = self._q_sorted_words
        qorder = self._q_pos_order
        alpha = 4 if self.nucleo else 20
        while True:
            n = lib.local_multi_c(
                self.scratch, self._es_scratch,
                q.ctypes.data, ql, t.ctypes.data, tl,
                sw.ctypes.data, qorder.ctypes.data, len(sw),
                self._ctl_c.ctypes.data, alpha, self.word_length,
                self._mx_ptr,
                self.ah.xdrop_u, self.ah.xdrop_g,
                self.ap.local_open, self.ap.local_ext,
                self.min_ungapped,
                self.es.gapped_lambda, self.es.log_gapped_k,
                self.es.db_size, max_evalue,
                self._mh_cap,
                self._mh_hsp.ctypes.data, self._mh_raw.ctypes.data,
                self._mh_paths.ctypes.data, self._mh_pcap,
                self._mh_poff.ctypes.data)
            if n == -3:
                self._mh_pcap *= 2
                self._mh_paths = np.empty(self._mh_pcap, np.uint8)
                continue
            if n == -4:
                self._mh_cap *= 2
                self._mh_hsp = np.empty(self._mh_cap * 4, np.int32)
                self._mh_raw = np.empty(self._mh_cap, np.float64)
                self._mh_poff = np.empty(self._mh_cap + 1, np.int64)
                continue
            break
        ars: List[AlignResult] = []
        hs = self._mh_hsp
        po = self._mh_poff
        pb = self._mh_paths
        for k in range(n):
            loi, loj, leni, lenj = (int(v) for v in hs[4 * k:4 * k + 4])
            path = pb[int(po[k]):int(po[k + 1])].tobytes().decode("ascii")
            raw = float(self._mh_raw[k])
            ar = AlignResult(
                query_label=self.query_label, target_label=t_label,
                query_seq=q, target_seq=t, path=path,
                nucleo=self.nucleo, local=True, loi=loi, loj=loj,
                raw_score=raw,
                evalue=self.es.raw_to_evalue(raw, ql, True))
            ar.leni_local = leni
            ar.lenj_local = lenj
            ar.bit_score = self.es.raw_to_bit(raw, True)
            ars.append(ar)
        return ars

    def align_multi(self, t_label: str, t_seq: np.ndarray
                    ) -> List[AlignResult]:
        """AlignMulti (src/localmulti.cpp:9-118): scan target words; at a
        seed hit try each query position in ascending order; a kept AR
        advances the scan to HSP.GetHij()+1; a discarded (LargeOverlap) AR
        falls through to the next query position."""
        ars: List[AlignResult] = []
        w = self.word_length
        if len(t_seq) < 2 * w:
            return ars
        q = self.query_seq
        ql = len(q)
        t = np.ascontiguousarray(t_seq)
        tl = len(t)
        q_ptr = q.ctypes.data
        t_ptr = t.ctypes.data
        max_evalue = options().flt("evalue")
        fast = self._multi_native(t_label, q, ql, t, tl, max_evalue)
        if fast is not None:
            return fast
        cached = self._tword_cache.get(id(t_seq))
        if cached is None:
            twords = _rolling_words(t, w, self.nucleo)
            self._tword_cache[id(t_seq)] = (t_seq, twords)
        else:
            twords = cached[1]
        n_tw = len(twords)
        hsps: List[HSP] = []

        sw = self._q_sorted_words
        qorder = self._q_pos_order
        lo_all = np.searchsorted(sw, twords, "left")
        hi_all = np.searchsorted(sw, twords, "right")
        tpos = 0
        while tpos < n_tw:
            lo, hi = lo_all[tpos], hi_all[tpos]
            kept_here = False
            if hi > lo:
                for qpos in qorder[lo:hi].tolist():
                    if not self._align_pos(q_ptr, ql, t_ptr, tl, qpos,
                                           tpos, max_evalue):
                        continue
                    ho = self._hsp_out
                    hsp = HSP(int(ho[0]), int(ho[1]), int(ho[2]),
                              int(ho[3]), float(self._score.value))
                    if any(_overlap_fract(hsp, kept) > 0.5
                           for kept in hsps):
                        continue  # KeepAR==false: try next query pos
                    path = self._path_buf.value.decode("ascii")
                    raw = float(f32(self.lib.score_local_path_c(
                        q[hsp.loi:].ctypes.data, t[hsp.loj:].ctypes.data,
                        path.encode("ascii"), len(path), self.mx,
                        self.ap.local_open, self.ap.local_ext)))
                    ar = AlignResult(
                        query_label=self.query_label,
                        target_label=t_label, query_seq=q,
                        target_seq=t, path=path, nucleo=self.nucleo,
                        local=True, loi=hsp.loi, loj=hsp.loj,
                        raw_score=raw,
                        evalue=self.es.raw_to_evalue(raw, ql, True))
                    ar.leni_local = hsp.leni
                    ar.lenj_local = hsp.lenj
                    ar.bit_score = self.es.raw_to_bit(raw, True)
                    hsps.append(hsp)
                    ars.append(ar)
                    new_tpos = hsp.hij + 1
                    tpos = new_tpos if new_tpos > tpos else tpos + 1
                    kept_here = True
                    break
            if not kept_here:
                tpos += 1
        return ars


def _overlap_fract(h1: HSP, h2: HSP) -> float:
    """HSPData::OverlapFract (src/hsp.h:74-89; NB overlap measured as
    MinHi - MaxLo, not +1)."""
    if h1.leni == 0 or h1.lenj == 0:
        return 0.0
    max_loi = max(h1.loi, h2.loi)
    max_loj = max(h1.loj, h2.loj)
    min_hii = min(h1.hii, h2.hii)
    min_hij = min(h1.hij, h2.hij)
    ovi = 0 if min_hii < max_loi else min_hii - max_loi
    ovj = 0 if min_hij < max_loj else min_hij - max_loj
    return (ovi * ovj) / (h1.leni * h1.lenj)
