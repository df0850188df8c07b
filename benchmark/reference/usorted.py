"""USEARCH's candidate ranking at or below -big targets (UDBUsortedSearcher:
SetU, SetTopBump and CountSortOrderDesc; src/udbusortedsearcher.cpp:205-282,
src/countsort.cpp:6-108), in plain NumPy, written from that description and
not from the port.

A target's words are reference/rank.py's: its distinct 8-letter words that
hold no letter of the database's default mask.  A query's are its distinct
valid words, every one looked up (no step below -big).  U[t] is the number
of the query's words that target t holds.

SetTopBump(MinU=1, Bump=50) walks the targets in index order and keeps
each whose U >= MinU; at a kept U above the largest kept before it (MaxU),
it raises MinU to U * Bump / 100 (an integer) where that lies above MinU
and below MaxU, then MaxU = U.  CountSortOrderDesc, over the kept targets
in that order: NextValue is the largest U before the first that reaches
the kept maximum; those below NextValue // 2 are dropped and the rest
ordered by U descending, ties in index order.
"""

from __future__ import annotations

import numpy as np

from . import rank


def incidence(seqs, w: int) -> np.ndarray:
    """(4**w, T) uint8: 1 where target t holds word x."""
    inc = np.zeros((4 ** w, len(seqs)), np.uint8)
    for t, s in enumerate(seqs):
        s = np.asarray(s)[None, :]
        letters = np.where(rank.fast_mask(s), 255, rank.CODE[s])
        words, ok = rank._windows(letters.astype(np.uint8), w)
        inc[words[ok], t] = 1
    return inc


def set_top_bump(u: np.ndarray, bump: int = 50):
    """(kept target indexes, their U) in index order."""
    min_u, max_u = 1, 0
    kept = []
    for t, x in enumerate(u.tolist()):
        if x < min_u:
            continue
        kept.append(t)
        if x > max_u:
            new_min = x * bump // 100
            if min_u < new_min < max_u:
                min_u = new_min
            max_u = x
    kept = np.array(kept, np.int64)
    return kept, u[kept].astype(np.int64)


def count_sort_desc(targets: np.ndarray, counts: np.ndarray):
    """CountSortOrderDesc of the kept targets: (targets, counts)."""
    if len(counts) == 0:
        return targets, counts
    first_max = int(np.argmax(counts))
    next_value = int(counts[:first_max].max()) if first_max else 0
    keep = counts >= next_value // 2
    targets, counts = targets[keep], counts[keep]
    order = np.argsort(-counts, kind="stable")
    return targets[order], counts[order]


def rank_lists(queries, inc: np.ndarray, w: int, topk: int,
               bump: int = 50):
    """[(targets, counts)] int64 arrays of each query's first `topk`
    ranked candidates."""
    out = []
    for q in queries:
        u = inc[rank.query_words(q, w)].sum(0, dtype=np.int64)
        t, c = count_sort_desc(*set_top_bump(u, bump))
        out.append((t[:topk], c[:topk]))
    return out
