"""Alignment result statistics from a path string.

Equivalent of AlignResult::FillLo and the per-field getters used by the
accepter and the output writers (src/arscorer.cpp:201-296, 554-596;
src/alignresult.h:151-170).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

import numpy as np

from ..alpha import MATCH_MX_AMINO, MATCH_MX_NUCLEO, TO_UPPER


@dataclass
class AlignResult:
    query_label: str
    target_label: str
    query_seq: np.ndarray
    target_seq: np.ndarray
    path: str
    nucleo: bool
    target_index: int = -1
    query_revcomp: bool = False
    target_revcomp: bool = False
    local: bool = False
    # translated-search ORF metadata (0 frame == not an ORF)
    orf_frame: int = 0
    orf_nuc_lo: int = 0
    orf_nuc_hi: int = 0
    orf_nuc_l: int = 0
    # plus-strand nucleotide query the ORF came from (m_ORFNucSeq)
    orf_nuc_seq: Optional[np.ndarray] = None
    # local-only coords (HSP segment); global => full spans
    loi: int = 0
    loj: int = 0
    raw_score: float = 0.0
    evalue: Optional[float] = None
    bit_score: Optional[float] = None

    def __post_init__(self) -> None:
        self._filled = False

    @property
    def la(self) -> int:
        return len(self.query_seq)

    @property
    def lb(self) -> int:
        return len(self.target_seq)

    def _fill(self) -> None:
        """FillLo (src/arscorer.cpp:201-296), vectorized (exact same
        counting semantics as the reference's per-column loop)."""
        if self._filled:
            return
        from ..native import path_stats
        pb = self.path.encode("ascii")
        st = path_stats(pb, np.ascontiguousarray(self.query_seq),
                        np.ascontiguousarray(self.target_seq),
                        self.loi, self.loj, self.nucleo)
        if st is not None:
            (first_m, last_m, self.first_m_qpos, self.first_m_tpos,
             self.last_m_qpos, self.last_m_tpos, id_count, diff_a,
             m_cols, gap_opens) = (int(v) for v in st)
            self.id_count = id_count
            self.mismatch_count = m_cols - id_count
            self.diff_count_a = diff_a
            self.first_m_col = first_m
            self.last_m_col = last_m
            self.aln_length = last_m - first_m + 1
            self.int_gap_count = self.aln_length - m_cols
            self.term_gap_count = len(pb) - self.aln_length
            self._gap_opens = gap_opens
            self._filled = True
            return
        path_b = np.frombuffer(pb, dtype=np.uint8)
        col_count = len(path_b)
        is_m = path_b == 77          # 'M'
        m_cols = np.nonzero(is_m)[0]
        assert len(m_cols) > 0, "path with no M columns"
        first_m = int(m_cols[0])
        last_m = int(m_cols[-1])

        q_step = is_m | (path_b == 68)   # M or D consume query
        t_step = is_m | (path_b == 73)   # M or I consume target
        # exclusive prefix: position consumed AT col
        qpos_at = self.loi + np.cumsum(q_step) - q_step
        tpos_at = self.loj + np.cumsum(t_step) - t_step
        self.first_m_qpos = int(qpos_at[first_m])
        self.first_m_tpos = int(tpos_at[first_m])
        self.last_m_qpos = int(qpos_at[last_m])
        self.last_m_tpos = int(tpos_at[last_m])

        match_mx = MATCH_MX_NUCLEO if self.nucleo else MATCH_MX_AMINO
        mq = self.query_seq[qpos_at[m_cols]]
        mt = self.target_seq[tpos_at[m_cols]]
        matches = match_mx[mq, mt]
        self.id_count = int(np.count_nonzero(matches))
        self.mismatch_count = len(m_cols) - self.id_count
        self.diff_count_a = int(
            np.count_nonzero(TO_UPPER[mq] != TO_UPPER[mt]))
        self.first_m_col = first_m
        self.last_m_col = last_m
        self.aln_length = last_m - first_m + 1
        self.int_gap_count = self.aln_length - len(m_cols)
        self.term_gap_count = col_count - self.aln_length
        self._filled = True

    # -- getters (reference names) -------------------------------------------
    def get_fract_id(self) -> float:
        self._fill()
        return 0.0 if self.aln_length == 0 else self.id_count / self.aln_length

    def get_pct_id(self) -> float:
        return 100.0 * self.get_fract_id()

    def get_aln_length(self) -> int:
        self._fill()
        return self.aln_length

    def get_mismatch_count(self) -> int:
        self._fill()
        return self.mismatch_count

    def get_diff_count(self) -> int:
        self._fill()
        return self.mismatch_count + self.int_gap_count

    def get_gap_count(self) -> int:
        self._fill()
        return self.int_gap_count

    def get_gap_open_count(self) -> int:
        """src/arscorer.cpp:554-569 (within FirstMCol..LastMCol)."""
        self._fill()
        cached = getattr(self, "_gap_opens", None)
        if cached is not None:
            return cached
        n = 0
        lastc = "M"
        for col in range(self.first_m_col, self.last_m_col + 1):
            c = self.path[col]
            if c != "M" and lastc == "M":
                n += 1
            lastc = c
        return n

    def get_query_cov(self) -> float:
        """GetQueryCov (src/arscorer.cpp:122-137): local => HSP Leni/QL,
        global => query letters spanned from first to last M column
        (LastMQPos - FirstMQPos + 1) / QL."""
        if self.local:
            return self.leni_local / self.la
        self._fill()
        return (self.last_m_qpos - self.first_m_qpos + 1) / self.la

    def get_target_cov(self) -> float:
        """GetTargetCov (src/arscorer.cpp:139-154): local => HSP Lenj/TL,
        global => M-column count (IdCount + MismatchCount) / TL — NOT the
        symmetric span formula; the reference is asymmetric here."""
        if self.local:
            return self.lenj_local / self.lb
        self._fill()
        return (self.id_count + self.mismatch_count) / self.lb

    def get_score(self) -> float:
        """HitMgr sort key: raw score for local, fract-id for global
        (src/arscorer.cpp:818-824), as float32."""
        if self.local:
            return float(np.float32(self.raw_score))
        return float(np.float32(self.get_fract_id()))

    # -- 1-based display coords ------------------------------------------------
    def q_coords_1(self):
        """(QLo6, QHi6): global => 1..LA.  For a revcomp query the reference
        maps query coords back to the plus strand (GetIQLo/GetIQHi,
        src/arscorer.cpp:688-745: IQLo = LA-Hii-1, IQHi = LA-Loi-1); the
        query is never flipped in blast6 unless ORF frame<0.  For an ORF
        query, amino positions map to nucleotide coords via
        PosToIPosQ (src/arscorer.cpp:598-645)."""
        if self.orf_frame:
            if self.local:
                loi = self.loi
                hii = self.loi + self.leni_local - 1
            else:
                loi, hii = 0, self.la - 1
            if self.orf_frame > 0:
                iqlo = self.orf_nuc_lo + loi * 3
                iqhi = self.orf_nuc_lo + hii * 3 + 2
            else:
                iqlo = self.orf_nuc_hi - hii * 3 - 2
                iqhi = self.orf_nuc_hi - loi * 3
            if self.orf_frame < 0:   # Blast6FlipQuery
                return iqhi + 1, iqlo + 1
            return iqlo + 1, iqhi + 1
        if self.local:
            if self.query_revcomp:
                hii = self.loi + self.leni_local - 1
                lo, hi = self.la - hii, self.la - self.loi
            else:
                lo, hi = self.loi + 1, self.loi + self.leni_local
        else:
            lo, hi = 1, self.la
        return lo, hi

    def t_coords_1(self):
        if self.local:
            lo, hi = self.loj + 1, self.loj + self.lenj_local
        else:
            lo, hi = 1, self.lb
        if self.query_revcomp:
            return hi, lo
        return lo, hi

    def compressed_path(self) -> str:
        """CompressPath (src/comppath.cpp): run-length MDI, count omitted
        when 1, e.g. 23M1D45M -> '23MD45M'? No: reference prints count always
        except 1 (verified against outputs: '=' for perfect)."""
        out = []
        path = self.path
        n = len(path)
        i = 0
        while i < n:
            c = path[i]
            j = i
            while j < n and path[j] == c:
                j += 1
            cnt = j - i
            if cnt == 1:
                out.append(c)
            else:
                out.append(f"{cnt}{c}")
            i = j
        return "".join(out)
