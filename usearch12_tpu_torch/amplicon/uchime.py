"""UCHIME3 de novo chimera detection.

DeParser (src/deparser.cpp), Make3Way (src/make3way.cpp), BimeraDP
(src/bimeradp.cpp) and the Uchime2DeNovo driver (src/uchime3denovo.cpp),
including the reference's parent-DB growth quirk: the scan pointer restarts
at the current SearchDB size, so with chimeras present some non-chimeric
parents are re-scanned and re-added (duplicated) — required for exact
output parity.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..alpha import CHAR_TO_LETTER_NUCLEO, MATCH_MX_NUCLEO, TO_UPPER
from ..config import options
from ..io.seqdb import SeqDB, size_from_label
from ..scoring import AlnParams, AlnHeuristics

UINT_MAX = 0xFFFFFFFF
MATCH_MX_NUCLEO_U8 = None   # lazily built uint8 view for the C kernels


def _match_mx_u8():
    global MATCH_MX_NUCLEO_U8
    if MATCH_MX_NUCLEO_U8 is None:
        MATCH_MX_NUCLEO_U8 = np.ascontiguousarray(
            MATCH_MX_NUCLEO.astype(np.uint8))
    return MATCH_MX_NUCLEO_U8

DEP_ERROR = "error"
DEP_PERFECT = "perfect"
DEP_PERFECT_CHIMERA = "perfect_chimera"
DEP_OFF_BY_ONE = "off_by_one"
DEP_OFF_BY_ONE_CHIMERA = "off_by_one_chimera"
DEP_SIMILAR = "similar"
DEP_OTHER = "other"


def strip_annots(label: str) -> str:
    """StripAllAnnots: keep text before the first ';'."""
    i = label.find(";")
    return label if i < 0 else label[:i]


def acc_from_label(label: str) -> str:
    """GetAccFromLabel (src/label.cpp:168-182)."""
    acc = []
    for c in label:
        if c in " |;":
            if "".join(acc) != "gi":
                return "".join(acc)
        acc.append(c)
    return "".join(acc)


def make_3way(q: np.ndarray, a: np.ndarray, b: np.ndarray,
              path_qa: str, path_qb: str) -> Tuple[str, str, str]:
    """Make3Way (src/make3way.cpp:4-132): star MSA of Q with A and B using
    per-Q-position max insert counts."""
    lq = len(q)
    ins_a = np.zeros(lq + 1, dtype=np.int64)
    qpos = 0
    for c in path_qa:
        if c in "MD":
            qpos += 1
        else:
            ins_a[qpos] += 1
    ins_b = np.zeros(lq + 1, dtype=np.int64)
    qpos = 0
    for c in path_qb:
        if c in "MD":
            qpos += 1
        else:
            ins_b[qpos] += 1
    ins = np.maximum(ins_a, ins_b)

    q_up = TO_UPPER[q]
    q3 = []
    for i in range(lq):
        q3.append("-" * int(ins[i]))
        q3.append(chr(q_up[i]))
    q3.append("-" * int(ins[lq]))
    q3 = "".join(q3)

    def row(seq: np.ndarray, path: str) -> str:
        seq_up = TO_UPPER[seq]
        out = []
        qpos = 0
        pos = 0
        pending_ins = 0
        for c in path:
            if c in "MD":
                out.append("-" * int(ins[qpos] - pending_ins))
                pending_ins = 0
                qpos += 1
            if c == "M":
                out.append(chr(seq_up[pos]))
                pos += 1
            elif c == "D":
                out.append("-")
            else:
                pending_ins += 1
                out.append(chr(seq_up[pos]))
                pos += 1
        out.append("-" * int(ins[lq] - pending_ins))
        return "".join(out)

    return q3, row(a, path_qa), row(b, path_qb)


def bimera_dp(q3: str, a3: str, b3: str):
    """BimeraDP (src/bimeradp.cpp:68-218).  Returns
    (a_first, col_end_first, col_start_second, diffs_qm, diffs_qt)."""
    n = len(q3)
    ql = CHAR_TO_LETTER_NUCLEO[np.frombuffer(q3.encode(), dtype=np.uint8)]
    al = CHAR_TO_LETTER_NUCLEO[np.frombuffer(a3.encode(), dtype=np.uint8)]
    bl = CHAR_TO_LETTER_NUCLEO[np.frombuffer(b3.encode(), dtype=np.uint8)]

    not_gap = np.array([c not in "-." for c in q3])
    nz = np.nonzero(not_gap)[0]
    if len(nz) == 0:
        return False, UINT_MAX, UINT_MAX, UINT_MAX, UINT_MAX
    col_lo, col_hi = int(nz[0]), int(nz[-1])

    in_range = np.zeros(n, dtype=bool)
    in_range[col_lo:col_hi + 1] = True
    d_qa = (ql != al) & in_range
    d_qb = (ql != bl) & in_range
    vd_qal = np.cumsum(d_qa)
    vd_qbl = np.cumsum(d_qb)

    diffs_qm = UINT_MAX
    col_start_second = UINT_MAX
    a_first = False
    d_qar = 0
    d_qbr = 0
    for col in range(col_hi - 1, col_lo, -1):
        if ql[col] != al[col]:
            d_qar += 1
        if ql[col] != bl[col]:
            d_qbr += 1
        dqm_ab = int(vd_qal[col - 1]) + d_qbr
        dqm_ba = int(vd_qbl[col - 1]) + d_qar
        if dqm_ab <= diffs_qm:
            if dqm_ab < diffs_qm:
                col_start_second = col
                diffs_qm = dqm_ab
                a_first = True
        elif dqm_ba <= diffs_qm:
            if dqm_ba < diffs_qm:
                col_start_second = col
                diffs_qm = dqm_ba
                a_first = False

    if col_start_second == UINT_MAX:
        return a_first, UINT_MAX, UINT_MAX, UINT_MAX, UINT_MAX

    col_end_first = col_start_second - 1
    while col_end_first > 0 and a3[col_end_first] == b3[col_end_first]:
        col_end_first -= 1

    diffs_qt = min(int(vd_qal[-1]), int(vd_qbl[-1]))
    return a_first, col_end_first, col_start_second, diffs_qm, diffs_qt


def _term_gaps_ok(path: str, max_d: int) -> bool:
    """TermGapsOk (src/deparser.cpp:84-104): limit terminal deletions."""
    i = 0
    while i < len(path) and path[i] == "D":
        if i > max_d:
            return False
        i += 1
    i = 0
    n = len(path)
    while i < n and path[n - i - 1] == "D":
        if i > max_d:
            return False
        i += 1
    return True


def get_left_right(q: np.ndarray, t: np.ndarray, path: str):
    """GetLeftRight (src/deparser.cpp:106-204).  Returns
    (diffs, pos_l0, pos_l1, pos_r0, pos_r1), UINT_MAX when undefined."""
    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        out = np.empty(5, np.int64)
        qc = q if q.flags["C_CONTIGUOUS"] else np.ascontiguousarray(q)
        tc = t if t.flags["C_CONTIGUOUS"] else np.ascontiguousarray(t)
        lib.uchime_left_right_c(qc.ctypes.data, tc.ctypes.data,
                                path.encode("ascii"), len(path),
                                _match_mx_u8().ctypes.data, 4,
                                out.ctypes.data)
        return tuple(int(v) for v in out)
    if not _term_gaps_ok(path, 4):
        return (UINT_MAX,) * 5
    n = len(path)
    # internal col range = first..last M column
    col_lo = col_hi = UINT_MAX
    for col, c in enumerate(path):
        if c == "M":
            if col_lo == UINT_MAX:
                col_lo = col
            col_hi = col
    mx = MATCH_MX_NUCLEO
    qpos = tpos = 0
    diffs = 0
    pos_l0 = pos_l1 = UINT_MAX
    for col, c in enumerate(path):
        if c == "M":
            if not mx[q[qpos], t[tpos]]:
                diffs += 1
            if diffs == 0:
                pos_l0 = qpos
            elif diffs == 1:
                pos_l1 = qpos
            qpos += 1
            tpos += 1
        else:
            if c == "D":
                qpos += 1
            if col_lo <= col <= col_hi:
                diffs += 1
                if diffs == 0:
                    pos_l0 = qpos
                elif diffs == 1:
                    pos_l1 = qpos
            if c == "I":
                tpos += 1
    diffs_r = 0
    pos_r0 = pos_r1 = UINT_MAX
    for k in range(n):
        col = n - k - 1
        c = path[col]
        if c == "M":
            qpos -= 1
            tpos -= 1
            if not mx[q[qpos], t[tpos]]:
                diffs_r += 1
            if diffs_r == 0:
                pos_r0 = qpos
            elif diffs_r == 1:
                pos_r1 = qpos
        else:
            if c == "D":
                qpos -= 1
            elif c == "I":
                tpos -= 1
            if col_lo <= col <= col_hi:
                diffs_r += 1
                if diffs_r == 0:
                    pos_r0 = qpos
                elif diffs_r == 1:
                    pos_r1 = qpos
    assert diffs_r == diffs
    return diffs, pos_l0, pos_l1, pos_r0, pos_r1


def _isgap(c: str) -> bool:
    return c == "-" or c == "."


def write_aln_pretty(f, a: np.ndarray, b: np.ndarray, path: str) -> None:
    """WriteAlnPretty (src/logaln.cpp:198-236) with StripTermGaps=True:
    80-col blocks of A row / annot row / B row, terminal gaps trimmed
    (TrimTermGaps, src/logaln.cpp:9-44)."""
    col_lo = col_hi = None
    a_lo = b_lo = 0
    i = j = 0
    for k, c in enumerate(path):
        if c == "M":
            if col_lo is None:
                col_lo = k
                a_lo, b_lo = i, j
            col_hi = k
        if c in "MD":
            i += 1
        if c in "MI":
            j += 1
    if col_lo is None:
        return

    def annot(qa: int, qb: int) -> str:
        ua, ub = TO_UPPER[qa], TO_UPPER[qb]
        if ua == ub:
            return "|"
        # g_SubstMx[a][b] > 0 only for same nucleotide letter with a
        # different character, i.e. the T/U pair (src/setnucmx.cpp)
        if {chr(ua), chr(ub)} == {"T", "U"}:
            return "+"
        return " "

    i, j = a_lo, b_lo
    col_from = col_lo
    while col_from <= col_hi:
        col_to = min(col_from + 79, col_hi)
        # A row
        i0, j0 = i, j
        out = ["%5u " % (i + 1)]
        for k in range(col_from, col_to + 1):
            c = path[k]
            if c in "MD":
                out.append(chr(a[i]))
                i += 1
            else:
                out.append("-")
        out.append(" %u\n" % i)
        f.write("".join(out))
        # annot row
        ii, jj = i0, j0
        out = ["      "]
        for k in range(col_from, col_to + 1):
            c = path[k]
            if c == "M":
                out.append(annot(int(a[ii]), int(b[jj])))
                ii += 1
                jj += 1
            else:
                if c == "D":
                    ii += 1
                else:
                    jj += 1
                out.append(" ")
        out.append("\n")
        f.write("".join(out))
        # B row
        out = ["%5u " % (j + 1)]
        for k in range(col_from, col_to + 1):
            c = path[k]
            if c in "MI":
                out.append(chr(b[j]))
                j += 1
            else:
                out.append("-")
        out.append(" %u\n" % j)
        f.write("".join(out))
        f.write("\n")
        col_from += 80


class DeParser:
    """src/deparser.cpp — classifies a query vs a parent candidate DB."""

    def __init__(self, aligner, nucleo: bool = True) -> None:
        self.aligner = aligner  # callable(q_seq, t_seq) -> path (never None)
        self.f_tab = None
        self.f_aln = None
        # native fused scan loop (uchime_parse_lo_c) when the aligner
        # exposes its NativeAligner; incremental target-concat cache
        self._na = getattr(aligner, "native", None)
        self._cat_db = None
        self._paths_buf = None
        self.clear()

    def clear(self) -> None:
        self.cls = DEP_ERROR
        self.top = UINT_MAX
        self.diffs_qt = UINT_MAX
        self.diffs_qm = UINT_MAX
        self.bimera_l = UINT_MAX
        self.bimera_r = UINT_MAX
        self.qseg_len_l = UINT_MAX
        self.best_l0 = self.best_r0 = UINT_MAX
        self.best_l1 = self.best_r1 = UINT_MAX
        self.pos_best_l0 = 0
        self.pos_best_l1 = 0
        self.pos_best_r0 = UINT_MAX
        self.pos_best_r1 = UINT_MAX
        self.paths: List[str] = []
        self.q3 = self.l3 = self.r3 = ""

    def parse(self, q_label: str, q_seq: np.ndarray, db: SeqDB) -> str:
        self.q_label = q_label
        self.q_seq = q_seq
        self.db = db
        self._parse_lo()
        self._set_3way()
        # terminal-gap glitch correction hack (src/deparser.cpp:398-406):
        # plain unsigned comparisons with UINT_MAX sentinels, reproduced
        # verbatim including the DiffsQM-vs-m_DiffsQT second condition
        dqm, dqt = self._diffs_from_3way()
        if dqm > self.diffs_qm:
            self.diffs_qm = dqm
        if dqm < self.diffs_qt:
            self.diffs_qt = dqt
        self._classify()
        if self.f_tab is not None:
            self._write_tabbed()
        if self.f_aln is not None:
            self._write_aln()
        return self.cls

    def _scan_py(self, n: int) -> None:
        for ti in range(n):
            t_seq = self.db.seqs[ti]
            path = self.aligner(self.q_seq, t_seq)
            assert path is not None
            self.paths.append(path)
            diffs, pl0, pl1, pr0, pr1 = get_left_right(
                self.q_seq, t_seq, path)
            if diffs != UINT_MAX and diffs < self.diffs_qt:
                self.top = ti
                self.diffs_qt = diffs
            if pl0 != UINT_MAX and pl0 > self.pos_best_l0:
                self.pos_best_l0 = pl0
                self.best_l0 = ti
            if pr0 != UINT_MAX and pr0 < self.pos_best_r0:
                self.pos_best_r0 = pr0
                self.best_r0 = ti
            if pl1 != UINT_MAX and pl1 > self.pos_best_l1:
                self.pos_best_l1 = pl1
                self.best_l1 = ti
            if pr1 != UINT_MAX and pr1 < self.pos_best_r1:
                self.pos_best_r1 = pr1
                self.best_r1 = ti
            if self.diffs_qt == 0:
                break

    def _scan_native(self, n: int) -> None:
        """One C call for the whole target scan (uchime_parse_lo_c)."""
        import ctypes
        na = self._na
        lib = na.lib
        db = self.db
        if self._cat_db is not db:
            self._cat_db = db
            self._cat = np.empty(1 << 16, np.uint8)
            self._cat_offs = np.zeros(1 << 10, np.int64)
            self._cat_n = 0
        while self._cat_n < n:           # append-only DB: extend the cache
            s = db.seqs[self._cat_n]
            end = int(self._cat_offs[self._cat_n])
            if self._cat_n + 2 > len(self._cat_offs):
                self._cat_offs = np.resize(self._cat_offs,
                                           2 * len(self._cat_offs))
            if end + len(s) > len(self._cat):
                self._cat = np.resize(self._cat,
                                      2 * (end + len(s)) + (1 << 16))
            self._cat[end:end + len(s)] = s
            self._cat_offs[self._cat_n + 1] = end + len(s)
            self._cat_n += 1
        q = self.q_seq
        qc = q if q.flags["C_CONTIGUOUS"] else np.ascontiguousarray(q)
        if self._paths_buf is None:
            self._paths_buf = np.empty(1 << 20, np.uint8)
            self._path_offs = np.empty(1 << 12, np.int64)
            self._state = np.empty(10, np.int64)
        if n + 2 > len(self._path_offs):
            self._path_offs = np.empty(2 * n + 2, np.int64)
        ah = na.ah
        while True:
            nd = lib.uchime_parse_lo_c(
                na._hf, na._scratch, ctypes.byref(na._gp),
                na._match.ctypes.data,
                ah.band_radius, ah.min_global_hsp_length,
                ah.min_global_hsp_fract_id, ah.min_global_hsp_score,
                ah.xdrop_global_hsp,
                qc.ctypes.data, len(qc),
                self._cat.ctypes.data, self._cat_offs.ctypes.data, n,
                self._paths_buf.ctypes.data, len(self._paths_buf),
                self._path_offs.ctypes.data, self._state.ctypes.data)
            if nd == -9:
                self._paths_buf = np.empty(4 * len(self._paths_buf),
                                           np.uint8)
                continue
            if nd < 0:
                raise RuntimeError(f"uchime_parse_lo_c error {nd}")
            break
        st = self._state
        (self.top, self.diffs_qt,
         self.best_l0, self.pos_best_l0, self.best_r0, self.pos_best_r0,
         self.best_l1, self.pos_best_l1, self.best_r1, self.pos_best_r1) = \
            (int(v) for v in st)
        self.paths = None   # fetch lazily via _path_of

    def _path_of(self, ti: int) -> str:
        if self.paths is not None:
            return self.paths[ti]
        o0 = int(self._path_offs[ti])
        o1 = int(self._path_offs[ti + 1])
        return self._paths_buf[o0:o1].tobytes().decode("ascii")

    def _parse_lo(self) -> None:
        self.clear()
        n = len(self.db)
        if self._na is not None and n > 0:
            self._scan_native(n)
        else:
            self._scan_py(n)
        if self.diffs_qt == 0:
            return
        # exact bimera (src/deparser.cpp:520-534)
        if (self.pos_best_l0 > 2 and self.pos_best_l0 != UINT_MAX
                and self.pos_best_r0 != UINT_MAX
                and self.pos_best_l0 + 1 >= self.pos_best_r0
                and self.best_l0 != self.best_r0):
            self.diffs_qm = 0
            self.bimera_l = self.best_l0
            self.bimera_r = self.best_r0
            self.qseg_len_l = self.pos_best_l0 + 1
            return
        # off-by-one L1R0
        if (self.diffs_qt > 4 and self.pos_best_l1 > 2
                and self.pos_best_l1 != UINT_MAX
                and self.pos_best_r0 != UINT_MAX
                and self.pos_best_l1 + 1 >= self.pos_best_r0
                and self.best_l1 != self.best_r0):
            self.diffs_qm = 1
            self.bimera_l = self.best_l1
            self.bimera_r = self.best_r0
            self.qseg_len_l = self.pos_best_l1 + 1
            return
        # off-by-one L0R1
        if (self.diffs_qt > 4 and self.pos_best_l0 > 2
                and self.pos_best_l0 != UINT_MAX
                and self.pos_best_r1 != UINT_MAX
                and self.pos_best_l0 + 1 >= self.pos_best_r1
                and self.best_l0 != self.best_r1):
            self.diffs_qm = 1
            self.bimera_l = self.best_l0
            self.bimera_r = self.best_r1
            self.qseg_len_l = self.pos_best_l1 + 1
            return

    def _set_3way(self) -> None:
        if self.bimera_l == UINT_MAX:
            return
        self.q3, self.l3, self.r3 = make_3way(
            self.q_seq, self.db.seqs[self.bimera_l],
            self.db.seqs[self.bimera_r],
            self._path_of(self.bimera_l), self._path_of(self.bimera_r))

    def _diffs_from_3way(self):
        if self.bimera_l == UINT_MAX:
            return UINT_MAX, UINT_MAX
        _af, _cef, _css, dqm, dqt = bimera_dp(self.q3, self.l3, self.r3)
        return dqm, dqt

    def _classify(self) -> None:
        self.cls = DEP_OTHER
        if self.diffs_qt == 0:
            self.cls = DEP_PERFECT
        elif self.diffs_qm == 0 and self.diffs_qt > 0:
            self.cls = DEP_PERFECT_CHIMERA
        elif self.diffs_qt == 1:
            self.cls = DEP_OFF_BY_ONE
        elif self.diffs_qt != UINT_MAX and \
                self.diffs_qt / len(self.q_seq) <= 0.1:
            self.cls = DEP_SIMILAR

    # -- reporting ------------------------------------------------------------
    def _label(self, idx: int) -> str:
        return "*" if idx == UINT_MAX else self.db.labels[idx]

    def get_ab_skew(self) -> float:
        if self.bimera_l != UINT_MAX:
            lsz = size_from_label(self._label(self.bimera_l), UINT_MAX)
            rsz = size_from_label(self._label(self.bimera_r), UINT_MAX)
            qsz = size_from_label(self.q_label, UINT_MAX)
            return min(lsz, rsz) / qsz
        if self.top != UINT_MAX:
            qsz = size_from_label(self.q_label, UINT_MAX)
            tsz = size_from_label(self._label(self.top), UINT_MAX)
            return tsz / qsz
        return -1.0

    def top_label_lr(self) -> str:
        if self.top == UINT_MAX:
            return "*"
        if self.top == self.bimera_l:
            return "(L)"
        if self.top == self.bimera_r:
            return "(R)"
        return self._label(self.top)

    def get_div_pct(self) -> float:
        if UINT_MAX in (self.bimera_l, self.bimera_r, self.top):
            return -1.0
        return self.pct_id_qm() - self.pct_id_qt()

    def pct_id_qt(self) -> float:
        if self.top == UINT_MAX or self.diffs_qt == UINT_MAX:
            return -1.0
        return 100.0 * (1.0 - self.diffs_qt / len(self.q_seq))

    def pct_id_qm(self) -> float:
        if self.diffs_qm == UINT_MAX:
            return -1.0
        return 100.0 * (1.0 - self.diffs_qm / len(self.q_seq))

    def append_info_str(self) -> str:
        """AppendInfoStr (src/deparser.cpp:1222-1268)."""
        def psasc(s: str, part: str) -> str:
            if s and not s.endswith(";"):
                s += ";"
            s += part
            if s and not s.endswith(";"):
                s += ";"
            return s

        s = ""
        if self.cls == DEP_ERROR:
            return "DEP_error"
        if self.cls in (DEP_PERFECT_CHIMERA, DEP_OFF_BY_ONE_CHIMERA):
            s = psasc(s, "dqm=%u;dqt=%u;div=%.1f;top=%s;parentL=%s;"
                      "parentR=%s;" % (
                          self.diffs_qm, self.diffs_qt, self.get_div_pct(),
                          strip_annots(self.top_label_lr()),
                          strip_annots(self._label(self.bimera_l)),
                          strip_annots(self._label(self.bimera_r))))
        elif self.cls in (DEP_PERFECT, DEP_OFF_BY_ONE):
            s = psasc(s, "dqt=%u;top=%s;" % (self.diffs_qt,
                                             self.top_label_lr()))
        elif self.cls == DEP_SIMILAR:
            s = psasc(s, "pctidqt=%.1f;top=%s;" % (self.pct_id_qt(),
                                                   self.top_label_lr()))
        elif self.cls == DEP_OTHER:
            s = "DEP_error"
        return s

    def _write_aln(self) -> None:
        """WriteAln (src/deparser.cpp:1072-1099): pretty top alignment for
        non-chimera classes, 3-way report for chimera classes."""
        f = self.f_aln
        if self.cls in (DEP_PERFECT, DEP_OFF_BY_ONE, DEP_SIMILAR):
            self._write_top_aln_pretty(f)
        elif self.cls in (DEP_PERFECT_CHIMERA, DEP_OFF_BY_ONE_CHIMERA):
            self._write_3way_pretty(f)

    def _write_top_aln_pretty(self, f) -> None:
        """WriteTopAlnPretty (src/deparser.cpp:1045-1070)."""
        f.write("\n")
        f.write(f">>>>> {self.cls} <<<<<\n")
        f.write("Query   (%5u nt) %s\n" % (len(self.q_seq), self.q_label))
        if self.top == UINT_MAX:
            f.write("  No hit found\n")
            return
        path = self._path_of(self.top)
        t_seq = self.db.seqs[self.top]
        f.write("Top     (%5u nt) %s\n" % (len(t_seq),
                                           self._label(self.top)))
        f.write("\n")
        write_aln_pretty(f, self.q_seq, t_seq, path)

    def _write_3way_pretty(self, f) -> None:
        """Write3WayPretty (src/deparser.cpp:783-942): L/Q/R 80-col blocks
        with a Diffs annotation row ('L'/'R'/'X' depending on which side of
        the crossover column ColEndFirst the difference falls)."""
        q3, a3, b3 = self.q3, self.l3, self.r3
        cols = len(q3)
        lq = len(self.q_seq)
        la = len(self.db.seqs[self.bimera_l])
        lb = len(self.db.seqs[self.bimera_r])

        col_lo = col_hi = None
        col_end_first = None
        qpos = 0
        for col in range(cols):
            if not _isgap(q3[col]):
                if col_lo is None:
                    col_lo = col
                col_hi = col
                qpos += 1
                if qpos == self.qseg_len_l:
                    col_end_first = col
        apos = sum(0 if _isgap(a3[c]) else 1 for c in range(col_lo))
        bpos = sum(0 if _isgap(b3[c]) else 1 for c in range(col_lo))
        qpos = 0

        f.write("\n")
        f.write(f">>>>> {self.cls} <<<<<\n")
        f.write("Query   (%5u nt) %s\n" % (lq, self.q_label))
        f.write("Left    (%5u nt) %s\n" % (la, self._label(self.bimera_l)))
        f.write("Right   (%5u nt) %s\n" % (lb, self._label(self.bimera_r)))

        row_from = col_lo
        while row_from <= col_hi:
            f.write("\n")
            row_to = min(row_from + 79, col_hi)
            out = ["L %5u " % (apos + 1)]
            for col in range(row_from, row_to + 1):
                a = a3[col]
                if a != q3[col]:
                    a = a.lower()
                out.append(a)
                if not _isgap(a):
                    apos += 1
            out.append(" %u\n" % apos)
            f.write("".join(out))

            out = ["Q %5u " % (qpos + 1)]
            for col in range(row_from, row_to + 1):
                q = q3[col]
                out.append(q)
                if not _isgap(q):
                    qpos += 1
            out.append(" %u\n" % qpos)
            f.write("".join(out))

            out = ["R %5u " % (bpos + 1)]
            for col in range(row_from, row_to + 1):
                b = b3[col]
                if b != q3[col]:
                    b = b.lower()
                out.append(b)
                if not _isgap(b):
                    bpos += 1
            out.append(" %u\n" % bpos)
            f.write("".join(out))

            out = ["Diffs   "]
            for col in range(row_from, row_to + 1):
                q, a, b = q3[col], a3[col], b3[col]
                c = " "
                if col <= col_end_first:
                    if q == a and q == b:
                        c = " "
                    elif q == a and q != b:
                        c = "L"
                    elif q == b and q != a:
                        c = "X"
                else:
                    if q == a and q == b:
                        c = " "
                    elif q == b and q != a:
                        c = "R"
                    else:
                        c = "X"
                out.append(c)
            out.append("\n")
            f.write("".join(out))
            row_from += 80
        f.write("\n")
        f.write("dQT %u, dQM %u, PctIdQT %.1f%%, PctIdQM %.1f%%,"
                "  Div %.1f%%\n" % (
                    self.diffs_qt, self.diffs_qm, self.pct_id_qt(),
                    self.pct_id_qm(), self.get_div_pct()))

    def _write_tabbed(self) -> None:
        """WriteTabbed (src/deparser.cpp:1001-1043)."""
        f = self.f_tab
        parts = [self.q_label, "+", self.cls]
        s = ""

        def psasc(s: str, part: str) -> str:
            if s and not s.endswith(";"):
                s += ";"
            s += part
            if s and not s.endswith(";"):
                s += ";"
            return s

        if self.diffs_qt != UINT_MAX:
            s = psasc(s, f"dqt={self.diffs_qt}")
            s = psasc(s, f"top={strip_annots(self._label(self.top))}")
        if self.diffs_qm != UINT_MAX:
            s = psasc(s, f"dqm={self.diffs_qm}")
        if self.bimera_l != UINT_MAX:
            s = psasc(s, f"parentL={strip_annots(self._label(self.bimera_l))}")
            s = psasc(s, f"parentR={strip_annots(self._label(self.bimera_r))}")
            s = psasc(s, "skew=%.3f" % self.get_ab_skew())
        if not s:
            s = "*"
        f.write("\t".join(parts) + "\t" + s + "\n")


def uchime2_denovo(input_db: SeqDB, aligner=None
                   ) -> Tuple[List[bool], List[str]]:
    """Uchime2DeNovo (src/uchime3denovo.cpp:22-157)."""
    o = options()
    nucleo = True
    if aligner is None:
        aligner = _make_gaforce_aligner(nucleo)

    dp = DeParser(aligner)
    if o.filled("uchimeout"):
        dp.f_tab = open(o.str("uchimeout"), "w")
    if o.filled("alnout"):
        dp.f_aln = open(o.str("alnout"), "w")
    # -uchimealnout is opened but never written in the reference
    # (src/uchime3denovo.cpp:55-57,152) => empty file
    f_uca = open(o.str("uchimealnout"), "w") \
        if o.filled("uchimealnout") else None

    min_abskew = o.flt("abskew", 16.0)
    is_chimera_vec: List[bool] = []
    info_strs: List[str] = []
    sizes: List[int] = []
    search_db = SeqDB()
    search_db.set_is_nucleo(True)
    search_seq_count = 0
    last_size = UINT_MAX

    for seq_index in range(len(input_db)):
        label = input_db.labels[seq_index]
        seq = input_db.seqs[seq_index]
        qsize = size_from_label(label, UINT_MAX)
        if qsize > last_size:
            raise SystemExit("Not sorted by size")
        sizes.append(qsize)

        # parent-DB growth with the reference's scan-pointer quirk
        min_size_parent = int(min_abskew * qsize)
        i = search_seq_count
        while i < seq_index:
            if sizes[i] < min_size_parent:
                break
            if not is_chimera_vec[i]:
                search_db.add(input_db.labels[i], input_db.seqs[i])
                search_seq_count += 1
            i += 1

        cls = dp.parse(label, seq, search_db)
        is_chimera = False
        info = dp.append_info_str()
        if cls == DEP_PERFECT:
            is_chimera = is_chimera_vec_search(
                is_chimera_vec, input_db, search_db, dp.top)
        elif cls == DEP_PERFECT_CHIMERA:
            is_chimera = True
        is_chimera_vec.append(is_chimera)
        info_strs.append(info)
        last_size = qsize

    if f_uca is not None:
        f_uca.close()
    if dp.f_tab is not None:
        dp.f_tab.close()
        dp.f_tab = None
    if dp.f_aln is not None:
        dp.f_aln.close()
        dp.f_aln = None
    return is_chimera_vec, info_strs


def is_chimera_vec_search(is_chimera_vec, input_db, search_db, top):
    """DEP_perfect propagates the chimera flag of the top parent.  The
    reference indexes IsChimeraVec by the SEARCH index (quirk: only valid
    because non-chimeras prefix-match input order when no duplicates)."""
    return is_chimera_vec[top] if top < len(is_chimera_vec) else False


def _make_gaforce_aligner(nucleo: bool):
    """GlobalAligner with m_FailIfNoHSPs=false (always returns a path)."""
    ap = AlnParams.from_cmdline(nucleo)
    ah = AlnHeuristics.from_cmdline(ap)
    try:
        from ..native import NativeAligner
        na = NativeAligner(ap, ah)

        def align(q, t):
            na.set_a(q)
            na.set_b(t)
            return na.global_align(full_dp_always=False,
                                   fail_if_no_hsps=False)
        align.native = na    # enables the fused C scan (uchime_parse_lo_c)
        return align
    except Exception:
        from ..align.hsp import HSPFinder
        from ..align.global_aligner import global_align
        hf = HSPFinder(ap, ah)

        def align(q, t):
            hf.set_a(q)
            hf.set_b(t)
            return global_align(q, t, ap, ah, hf, fail_if_no_hsps=False)
        return align


def uchime3_denovo(input_path: Optional[str]) -> None:
    """cmd_uchime3_denovo (src/uchime3denovo.cpp:159-205)."""
    from ..io.fastx import write_fasta
    o = options()
    o.set_default("abskew", 16.0)
    input_db = SeqDB.from_fastx(input_path)
    is_chimera_vec, _infos = uchime2_denovo(input_db)
    f_ch = open(o.str("chimeras"), "w") if o.filled("chimeras") else None
    f_non = open(o.str("nonchimeras"), "w") if o.filled("nonchimeras") \
        else None
    for i in range(len(input_db)):
        f = f_ch if is_chimera_vec[i] else f_non
        if f:
            write_fasta(f, input_db.labels[i], input_db.seqs[i],
                        o.uns("fasta_cols"))
    for f in (f_ch, f_non):
        if f:
            f.close()
