"""Per-query hit accumulator (src/hitmgr.{h,cpp}).

Hits are AlignResult objects; output order = descending float32 score
(QuickSortOrderDesc); top hit = max score with lowest target index on ties
(src/hitmgr.cpp:400-420).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def quick_sort_order(values, desc: bool = True):
    """QuickSortOrderRecurse (src/sort.h:62-101): Hoare partition around the
    middle element; identical swap sequence => identical tie ordering.
    Large inputs run the identical algorithm in C (quick_sort_order_c);
    double holds every score/size exactly, so the swap sequence — and
    therefore the tie order — is unchanged."""
    n = len(values)
    if n >= 64:
        try:
            vals = np.ascontiguousarray(values, dtype=np.float64)
        except (TypeError, ValueError):
            vals = None
        if vals is not None and vals.ndim == 1:
            from ..native import get_lib
            lib = get_lib()
            if lib is not None:
                out = np.empty(n, np.int64)
                lib.quick_sort_order_c(vals.ctypes.data, n, int(desc),
                                       out.ctypes.data)
                return out.tolist()
    order = list(range(n))
    if n == 0:
        return order

    def recurse(left: int, right: int) -> None:
        i, j = left, right
        pivot = values[order[(left + right) // 2]]
        while i <= j:
            if desc:
                while values[order[i]] > pivot:
                    i += 1
                while values[order[j]] < pivot:
                    j -= 1
            else:
                while values[order[i]] < pivot:
                    i += 1
                while values[order[j]] > pivot:
                    j -= 1
            if i <= j:
                order[i], order[j] = order[j], order[i]
                i += 1
                j -= 1
        if left < j:
            recurse(left, j)
        if i < right:
            recurse(i, right)

    recurse(0, n - 1)
    return order


class HitMgr:
    def __init__(self) -> None:
        self.hits: List = []
        self.query_count = 0
        self.query_with_hit_count = 0

    @property
    def hit_count(self) -> int:
        return len(self.hits)

    def set_query(self, _label: str) -> None:
        self.hits = []

    def append_hit(self, ar) -> None:
        self.hits.append(ar)

    def top_hit(self):
        """GetTopHit: strict > on score, tie -> lowest target index."""
        if not self.hits:
            return None
        best = self.hits[0]
        best_score = np.float32(best.get_score())
        best_tix = best.target_index
        for ar in self.hits[1:]:
            s = np.float32(ar.get_score())
            tix = ar.target_index
            if s > best_score or (s == best_score and tix < best_tix):
                best, best_score, best_tix = ar, s, tix
        return best

    def sorted_hits(self) -> List:
        """GetHit order: QuickSortOrderDesc on float32 scores — the exact
        Hoare-partition quicksort from src/sort.h:62-101 so tie order
        matches the reference bit-for-bit.  Applies the GetHitCount caps
        (src/hitmgr.cpp:367-397): -maxhits truncation, -top_hit_only
        (GetTopHit tie rule), -top_hits_only (ties with top score)."""
        from ..config import options
        o = options()
        if not self.hits:
            return []
        if o.flag("top_hit_only"):
            return [self.top_hit()]
        scores = [np.float32(h.get_score()) for h in self.hits]
        order = quick_sort_order(scores, desc=True)
        n = len(order)
        if o.filled("maxhits"):
            n = min(n, o.uns("maxhits"))
        if o.flag("top_hits_only"):
            top = scores[order[0]]
            m = 1
            while m < n and scores[order[m]] >= top:
                m += 1
            n = m
        return [self.hits[i] for i in order[:n]]

    def min_fract_id(self) -> float:
        return min((h.get_fract_id() for h in self.hits), default=1.0)

    def max_fract_id(self) -> float:
        return max((h.get_fract_id() for h in self.hits), default=0.0)

    def on_query_done(self, query_label: str, sinks) -> None:
        self.query_count += 1
        if self.hits:
            self.query_with_hit_count += 1
