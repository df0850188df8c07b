"""HSP seed-find / ungapped x-drop extension / collinear chaining.

Host implementation with exact reference semantics:
  - word dictionary over A with MaxReps=8 (src/hspfinder.cpp:304-323)
  - rolling words that map invalid/masked letters to letter 0
    (src/hspfinder.cpp:226-270 SeqToWords; NB: lowercase chars keep their
    letter — only non-alphabet chars degrade to 0)
  - UngappedBlast scan over B positions with right/left x-drop extension and
    the HSPFound short-circuit (src/ungappedblast.cpp:8-211)
  - staggered-HSP suppression IsGlobalHSP (src/hspfinder.cpp:594-636)
  - Chainer sweep (src/chainer.cpp:352-500); the reference's
    delete-enclosed-chains branch is a no-op (compares a score with itself)
    so chains are never deleted — reproduced by simply not deleting.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..alpha import CHAR_TO_LETTER_AMINO, CHAR_TO_LETTER_NUCLEO
from ..scoring import AlnParams, AlnHeuristics

MAX_REPS = 8
f32 = np.float32


@dataclass
class HSP:
    loi: int
    loj: int
    leni: int
    lenj: int
    score: float = 0.0

    @property
    def hii(self) -> int:
        return self.loi + self.leni - 1

    @property
    def hij(self) -> int:
        return self.loj + self.lenj - 1

    def length(self) -> int:
        assert self.leni == self.lenj
        return self.leni

    def left_a(self) -> bool:
        return self.loi == 0

    def left_b(self) -> bool:
        return self.loj == 0

    def right_a(self, la: int) -> bool:
        return self.loi + self.leni == la

    def right_b(self, lb: int) -> bool:
        return self.loj + self.lenj == lb

    def is_staggered(self, la: int, lb: int) -> bool:
        """src/hsp.h:102-126."""
        tg_la = self.loi - self.loj
        tg_lb = self.loj - self.loi
        tg_ra = (la - self.hii - 1) - (lb - self.hij - 1)
        tg_rb = (lb - self.hij - 1) - (la - self.hii - 1)
        tg_la = max(tg_la, 0)
        tg_lb = max(tg_lb, 0)
        tg_rb = max(tg_rb, 0)
        gap_a = tg_la + tg_ra
        gap_b = tg_lb + tg_rb
        if gap_a == 0 or gap_b == 0:
            return False
        r = gap_a / la if la < lb else gap_b / lb
        return r > 0.5


def seq_to_hsp_words(seq: np.ndarray, word_length: int, nucleo: bool
                     ) -> np.ndarray:
    """Rolling k-mer words; invalid letters (incl. wildcards) -> 0.
    Lowercase letters keep their letter value (char table maps them)."""
    table = CHAR_TO_LETTER_NUCLEO if nucleo else CHAR_TO_LETTER_AMINO
    alpha_size = 4 if nucleo else 20
    L = len(seq)
    if L < word_length:
        return np.zeros(0, dtype=np.int64)
    letters = table[seq].astype(np.int64)
    letters[letters >= alpha_size] = 0
    n = L - word_length + 1
    words = np.zeros(n, dtype=np.int64)
    for k in range(word_length):
        words = words * alpha_size + letters[k:k + n]
    return words


def is_global_hsp(alo: int, blo: int, length: int, la: int, lb: int) -> bool:
    """src/hspfinder.cpp:594-636."""
    if la <= lb:
        max_gap = la // 4 + 1
        if alo > blo and (alo - blo) > max_gap:
            return False
        ar, br = la - alo, lb - blo
        if ar > br and (ar - br) > max_gap:
            return False
    else:
        max_gap = lb // 4 + 1
        if blo > alo and (blo - alo) > max_gap:
            return False
        ar, br = la - alo, lb - blo
        if br > ar and (br - ar) > max_gap:
            return False
    return True


class HSPFinder:
    """Per-(query,target) seed & extend state."""

    def __init__(self, ap: AlnParams, ah: AlnHeuristics) -> None:
        self.ah = ah
        self.subst_mx = ap.subst_mx
        self.word_length = ah.hsp_word_length
        self.nucleo = ap.nucleo
        self.alpha_size = 4 if ap.nucleo else 20
        self.word_count = self.alpha_size ** self.word_length
        self.a: Optional[np.ndarray] = None
        self.b: Optional[np.ndarray] = None
        self.words_a: Optional[np.ndarray] = None
        self.words_b: Optional[np.ndarray] = None
        # dict: word -> first MAX_REPS positions in A
        self.word_to_pos_a = {}

    def set_a(self, a: np.ndarray) -> None:
        self.a = a
        self.words_a = seq_to_hsp_words(a, self.word_length, self.nucleo)
        d = {}
        for pos, w in enumerate(self.words_a.tolist()):
            lst = d.get(w)
            if lst is None:
                d[w] = [pos]
            elif len(lst) < MAX_REPS:
                lst.append(pos)
        self.word_to_pos_a = d

    def set_b(self, b: np.ndarray) -> None:
        self.b = b
        self.words_b = seq_to_hsp_words(b, self.word_length, self.nucleo)

    # -- ungapped blast ------------------------------------------------------
    def ungapped_blast(self, x: float, stagger_ok: bool, min_length: int,
                       min_score: float) -> List[HSP]:
        """src/ungappedblast.cpp:8-211. Float32 accumulation order preserved."""
        hsps: List[HSP] = []
        a, b = self.a, self.b
        la, lb = len(a), len(b)
        w = self.word_length
        if lb < 2 * w:
            return hsps
        mx = self.subst_mx
        x = f32(x)
        min_score = f32(min_score)
        words_b = self.words_b
        n_words_b = len(words_b)
        d = self.word_to_pos_a

        bpos = 0
        while bpos < n_words_b:
            positions = d.get(int(words_b[bpos]))
            if not positions:
                bpos += 1
                continue
            found = False
            for apos in positions:
                diag = la + bpos - apos
                bpos2 = bpos + w - 1
                apos2 = apos + w - 1
                if apos2 >= la or bpos2 >= lb:
                    continue
                score = f32(0)
                for j in range(w):
                    score = f32(score + mx[a[apos + j], b[bpos + j]])
                best_score = score
                best_bpos2 = bpos2
                # extend right
                while True:
                    bpos2 += 1
                    if bpos2 >= lb:
                        break
                    apos2 += 1
                    if apos2 >= la:
                        break
                    score = f32(score + mx[a[apos2], b[bpos2]])
                    if score > best_score:
                        best_score = score
                        best_bpos2 = bpos2
                    elif f32(best_score - score) > x:
                        break
                # extend left
                apos1, bpos1 = apos, bpos
                best_bpos1 = bpos1
                score = best_score
                while True:
                    if bpos1 == 0 or apos1 == 0:
                        break
                    bpos1 -= 1
                    apos1 -= 1
                    score = f32(score + mx[a[apos1], b[bpos1]])
                    if score > best_score:
                        best_score = score
                        best_bpos1 = bpos1
                    elif f32(best_score - score) > x:
                        break

                blo, bhi = best_bpos1, best_bpos2
                length = bhi - blo + 1
                alo = la + best_bpos1 - diag
                ok = length >= min_length and best_score >= min_score
                if not stagger_ok:
                    ok = ok and is_global_hsp(alo, blo, length, la, lb)
                if ok:
                    hsps.append(HSP(alo, blo, length, length,
                                    float(best_score)))
                    bpos = bhi + 1
                    found = True
                    break
            if not found:
                bpos += 1
        return hsps

    # -- chaining --------------------------------------------------------------
    @staticmethod
    def chain(hsps: List[HSP]) -> List[HSP]:
        """Chainer::Chain (src/chainer.cpp:352-500). Bendpoint sweep over
        Loi/Hii sorted (pos, lo-before-hi) with qsort (unstable for exact
        ties, but reference comparator returns 0 only for same pos+type;
        glibc qsort is then order-preserving within our stable sort)."""
        n = len(hsps)
        if n == 0:
            return []
        bps = []  # (pos, is_hi(0=lo first), index)
        for idx, h in enumerate(hsps):
            bps.append((h.loi, 0, idx))
            bps.append((h.hii, 1, idx))
        bps.sort(key=lambda t: (t[0], t[1]))

        chain_score = [None] * n
        prev_idx = [-1] * n
        chains: List[int] = []  # insertion-ordered live chain list
        for pos, is_hi, idx in bps:
            h = hsps[idx]
            if not is_hi:
                # find best chain with hii < h.loi and hij < h.loj
                best = -1
                best_score = None
                for c in chains:
                    ch = hsps[c]
                    if ch.hii < h.loi and ch.hij < h.loj and \
                            (best == -1 or chain_score[c] > best_score):
                        best = c
                        best_score = chain_score[c]
                chains.append(idx)
                prev_idx[idx] = best
                chain_score[idx] = f32(h.score) if best == -1 else \
                    f32(chain_score[best] + f32(h.score))
            # is_hi: reference's delete-enclosed loop never fires (it
            # compares chain_score[idx] < chain_score[idx]) -> no-op.

        opt = 0
        opt_score = chain_score[0]
        for i in range(1, n):
            if chain_score[i] > opt_score:
                opt = i
                opt_score = chain_score[i]
        out = []
        i = opt
        while i != -1:
            out.append(hsps[i])
            i = prev_idx[i]
        out.reverse()
        return out

    def get_global_hsps(self, min_length: int, stagger_ok: bool = False):
        """GetGlobalHSPs (src/getglobalhsps.cpp:9-61) + Chain with staggered
        filter (src/hspfinder.cpp:537-553). Returns (chained, fract_id)."""
        from ..alpha import MATCH_MX_AMINO, MATCH_MX_NUCLEO
        x = self.ah.xdrop_global_hsp
        hsps = self.ungapped_blast(x, stagger_ok, min_length,
                                   self.ah.min_global_hsp_score)
        chained = self.chain(hsps)
        # staggered filter
        la, lb = len(self.a), len(self.b)
        for h in chained:
            if h.is_staggered(la, lb):
                chained = []
                break
        total_len = 0
        total_same = 0
        match_mx = MATCH_MX_NUCLEO if self.nucleo else MATCH_MX_AMINO
        for h in chained:
            if h.leni != h.lenj:
                return [], -1.0
            total_len += h.length()
            total_same += int(match_mx[self.a[h.loi:h.loi + h.leni],
                                       self.b[h.loj:h.loj + h.lenj]].sum())
        fract_id = 0.0 if total_len == 0 else total_same / total_len
        return chained, fract_id
