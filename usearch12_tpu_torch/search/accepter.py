"""Accept predicate for alignments and pre-alignment pair rejection.

Reference: src/accepter.cpp:27-95 (IsAcceptLo), :140-198 (RejectPair).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import options
from ..io.seqdb import size_from_label


class Accepter:
    def __init__(self, is_global: bool, accept_all: bool = False) -> None:
        self.is_global = is_global
        self.accept_all = accept_all
        # options are fixed by the time a search context exists; cache
        # every gate (o.filled/o.flt per AR was measurable in profiles)
        o = options()

        def flt(n):
            return o.flt(n) if o.filled(n) else None

        def uns(n):
            return o.uns(n) if o.filled(n) else None
        self._f_self = o.flag("self")
        self._f_notself = o.flag("notself")
        self._f_selfid = o.flag("selfid")
        self._min_sizeratio = flt("min_sizeratio")
        self._minqt = flt("minqt")
        self._maxqt = flt("maxqt")
        self._minsl = flt("minsl")
        self._maxsl = flt("maxsl")
        self._id = flt("id")
        self._maxid = flt("maxid")
        self._mincols = uns("mincols")
        self._maxgaps = uns("maxgaps")
        self._evalue = flt("evalue")
        self._query_cov = flt("query_cov")
        self._max_query_cov = flt("max_query_cov")
        self._target_cov = flt("target_cov")
        self._max_target_cov = flt("max_target_cov")
        self._maxdiffs = uns("maxdiffs")
        self._mindiffs = uns("mindiffs")
        self._abskew = flt("abskew")
        self._any_pair_ratio = (self._minqt is not None
                                or self._maxqt is not None
                                or self._minsl is not None
                                or self._maxsl is not None)

    def reject_pair(self, q_label: str, q_seq: np.ndarray,
                    t_label: str, t_seq: np.ndarray) -> bool:
        if self.accept_all:
            return False
        if self._f_self and q_label == t_label:
            return True
        if self._f_notself and q_label != t_label:
            return True
        if self._f_selfid and self.is_global:
            if len(q_seq) == len(t_seq) and np.array_equal(q_seq, t_seq):
                return True
        if self._min_sizeratio is not None:
            qsize = size_from_label(q_label, -1)
            tsize = size_from_label(t_label, -1)
            assert qsize > 0 and tsize > 0
            if tsize / qsize < self._min_sizeratio:
                return True
        if self._any_pair_ratio:
            ql, tl = len(q_seq), len(t_seq)
            assert ql != 0 and tl != 0
            qt = ql / tl
            sl = min(ql, tl) / max(ql, tl)
            if self._minqt is not None and qt < self._minqt:
                return True
            if self._maxqt is not None and qt > self._maxqt:
                return True
            if self._minsl is not None and sl < self._minsl:
                return True
            if self._maxsl is not None and sl > self._maxsl:
                return True
        return False

    def is_accept(self, ar) -> bool:
        if ar is None:
            return False
        return self._is_accept_lo(ar)

    def _is_accept_lo(self, ar) -> bool:
        if self.accept_all:
            return True
        if self.reject_pair(ar.query_label, ar.query_seq,
                            ar.target_label, ar.target_seq):
            return False
        if self._id is not None:
            fract_id = ar.get_fract_id()
            if fract_id < self._id:
                return False
            if self._maxid is not None and fract_id > self._maxid:
                return False
        if self._mincols is not None                 and ar.get_aln_length() < self._mincols:
            return False
        if self._maxgaps is not None                 and ar.get_gap_count() > self._maxgaps:
            return False
        if self._evalue is not None:
            if ar.evalue is None or ar.evalue > self._evalue:
                return False
        if self._query_cov is not None or self._max_query_cov is not None:
            cov = ar.get_query_cov()
            if self._query_cov is not None and cov < self._query_cov:
                return False
            if self._max_query_cov is not None                     and cov > self._max_query_cov:
                return False
        if self._target_cov is not None                 or self._max_target_cov is not None:
            cov = ar.get_target_cov()
            if self._target_cov is not None and cov < self._target_cov:
                return False
            if self._max_target_cov is not None                     and cov > self._max_target_cov:
                return False
        if self._maxdiffs is not None                 and ar.get_diff_count() > self._maxdiffs:
            return False
        if self._mindiffs is not None                 and ar.get_diff_count() < self._mindiffs:
            return False
        if self._abskew is not None:
            qsize = size_from_label(ar.query_label, -1)
            tsize = size_from_label(ar.target_label, -1)
            if tsize / qsize < self._abskew:
                return False
        return True
