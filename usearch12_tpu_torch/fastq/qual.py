"""FASTQ quality model (src/fastq.cpp).

Phred offset handling (33/64 w/ autodetect), qual->prob tables, expected
error, and the paired-read posterior-quality tables used by the merger.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..config import options


class FastQ:
    def __init__(self, base: int = 33, qmin: int = 0, qmax: int = 41,
                 qmax_out: int = 41) -> None:
        self.base = base
        self.qmin = qmin
        self.qmax = qmax
        self.qmax_out = qmax_out
        self.char_to_prob = np.zeros(256)
        for iq in range(qmin, qmax + 1):
            ch = self.int_to_char(iq)
            self.char_to_prob[ch] = 10.0 ** (-iq / 10.0)
        self._init_merge()

    @classmethod
    def from_cmdline(cls) -> "FastQ":
        o = options()
        return cls(o.uns("fastq_ascii"), o.uns("fastq_qmin"),
                   o.uns("fastq_qmax"), o.uns("fastq_qmaxout"))

    def int_to_char(self, iq: int) -> int:
        return iq + self.base

    def char_to_int(self, ch: int) -> int:
        return ch - self.base

    def get_ee(self, qual) -> float:
        """Expected errors; sequential double adds (numpy's pairwise sum
        rounds differently from the reference's scalar loop)."""
        if len(qual) > 32:
            from ..native import get_lib
            lib = get_lib()
            if lib is not None:
                b = qual if isinstance(qual, bytes) \
                    else qual.encode("latin1")
                return lib.ee_sum_c(b, len(b),
                                    self._ctp_c().ctypes.data)
        s = 0.0
        for q in qual:
            s += self.char_to_prob[ord(q) if isinstance(q, str) else q]
        return s

    def _ctp_c(self):
        t = getattr(self, "_ctp", None)
        if t is None:
            t = self._ctp = np.ascontiguousarray(self.char_to_prob)
        return t

    def _init_merge(self) -> None:
        """InitMerge (src/fastq.cpp:160-229): posterior Q for agreeing and
        disagreeing base pairs."""
        n = self.qmax + 1
        self.pair_match_int = np.zeros((64, 64), dtype=np.uint8)
        self.pair_mismatch_int = np.zeros((64, 64), dtype=np.uint8)
        for q1 in range(self.qmin, n):
            p1 = 10.0 ** (-q1 / 10.0)
            for q2 in range(self.qmin, n):
                p2 = 10.0 ** (-q2 / 10.0)
                pc = (1.0 - p1) * (1.0 - p2)
                pf = (1.0 - p1) * p2
                pr = (1.0 - p2) * p1
                pw = (2.0 / 3.0) * p1 * p2
                px = (1.0 / 3.0) * p1 * p2
                pa = pc + px
                pd = pf + pr + pw
                p_match = px / pa
                p_mismatch = (pr + pw) / pd
                qm = int(-10.0 * math.log10(p_match) + 0.5)
                qmm = int(-10.0 * math.log10(p_mismatch) + 0.5)
                qm = min(max(qm, self.qmin), self.qmax_out)
                qmm = min(max(qmm, self.qmin), self.qmax_out)
                self.pair_match_int[q1, q2] = qm
                self.pair_match_int[q2, q1] = qm
                self.pair_mismatch_int[q1, q2] = qmm
                self.pair_mismatch_int[q2, q1] = qmm

    @staticmethod
    def guess_base(path: str) -> Optional[int]:
        """GuessBase: chars < '@'(64) => 33; chars > 'J'+ ... simple rule:
        any qual char < 59 => base 33; all >= 64 => maybe 64."""
        from ..io.fastx import read_fastq
        n = 0
        min_ch = 255
        max_ch = 0
        for _l, _s, qual in read_fastq(path):
            for c in qual:
                ch = ord(c)
                min_ch = min(min_ch, ch)
                max_ch = max(max_ch, ch)
            n += 1
            if n >= 100:
                break
        if n == 0:
            return None
        if min_ch < 59:
            return 33
        if min_ch >= 64:
            return 64
        return None


_fastq_singleton = None


def get_fastq() -> FastQ:
    global _fastq_singleton
    if _fastq_singleton is None:
        _fastq_singleton = FastQ.from_cmdline()
    return _fastq_singleton


def reset_fastq() -> None:
    global _fastq_singleton
    _fastq_singleton = None
