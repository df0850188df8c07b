"""Six-frame ORF enumeration for translated search (nt query vs aa DB).

Faithful port of ORFFinder (src/orffinder.{h,cpp}) including its quirks:
  - frame order -3,-2,-1,+1,+2,+3 (or +1..+3 with -orf_plusonly)
  - -orfstyle bits (default 5): 1 = ORF may start at seq start, 2 = ORF
    restarts right after a stop, 4 = ORF may end at seq end, 8 = include
    the stop codon in the ORF
  - without style bit 4, enumeration ends entirely at the first frame end
    (src/orffinder.cpp:124-130 returns false, not next-frame)
  - reverse-strand translation uses g_CharToCompLetter, whose lowercase
    'c'/'u' entries are INVALID in the reference table
    (src/alpha.cpp:3525+) — replicated here
  - any invalid letter in a codon translates to 'X'
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..config import options
from ..alpha import CHAR_TO_LETTER_NUCLEO, CODON_WORD_TO_AMINO_CHAR

# g_CharToCompLetter (src/alpha.cpp:3525+): only these chars map; note the
# reference's table has no lowercase 'c' or 'u' entries (quirk).
CHAR_TO_COMP_LETTER = np.full(256, 0xFF, dtype=np.uint8)
for _c, _l in ((65, 3), (67, 2), (71, 1), (84, 0), (85, 0),
               (97, 3), (103, 1), (116, 0)):
    CHAR_TO_COMP_LETTER[_c] = _l

_STAR = ord("*")
_M = ord("M")
_X = ord("X")


def orf_iter(nuc_seq: np.ndarray
             ) -> Iterator[Tuple[np.ndarray, int, int, int]]:
    """Yields (amino_seq, frame, nuc_lo, nuc_hi) per accepted ORF, in the
    reference's enumeration order."""
    o = options()
    plus_only = o.flag("orf_plusonly")
    min_codons = o.uns("mincodons", 20)
    style = o.uns("orfstyle", 5)
    start_at_seq_start = bool(style & 1)
    start_after_stop = bool(style & 2)
    end_at_seq_end = bool(style & 4)
    include_stop = bool(style & 8)

    L = len(nuc_seq)
    fwd = CHAR_TO_LETTER_NUCLEO[nuc_seq].astype(np.int64)
    rev = CHAR_TO_COMP_LETTER[nuc_seq].astype(np.int64)
    frames = (1, 2, 3) if plus_only else (-3, -2, -1, 1, 2, 3)

    for frame in frames:
        if frame > 0:
            pos = frame - 1
        else:
            pos = L + frame  # -3 -> L-3, -2 -> L-2, -1 -> L-1
        in_orf = start_at_seq_start
        start_pos = pos
        buf: list = []

        while True:
            saved_pos = pos
            # GetNextAminoChar (src/orffinder.cpp:52-106)
            if frame > 0:
                ok = pos + 3 <= L
                if ok:
                    x1, x2, x3 = fwd[pos], fwd[pos + 1], fwd[pos + 2]
                    pos += 3
            else:
                ok = pos >= 2
                if ok:
                    x1, x2, x3 = rev[pos], rev[pos - 1], rev[pos - 2]
                    pos -= 3
            if ok:
                if x1 > 3 or x2 > 3 or x3 > 3:
                    a = _X
                else:
                    a = int(CODON_WORD_TO_AMINO_CHAR[16 * x1 + 4 * x2 + x3])

            stop = False
            if not ok:
                if end_at_seq_end:
                    stop = True
                else:
                    return   # reference quirk: ends ALL enumeration
            elif a == _STAR:
                stop = True
                if include_stop:
                    buf.append(_STAR)

            if stop:
                if in_orf and len(buf) >= min_codons:
                    amino_l = len(buf)
                    if frame > 0:
                        lo = start_pos
                        hi = lo + amino_l * 3 - 1
                    else:
                        hi = start_pos
                        lo = hi + 1 - amino_l * 3
                    aa = np.array(buf, dtype=np.uint8)
                    if start_after_stop:
                        start_pos = saved_pos
                        in_orf = True
                    else:
                        in_orf = False
                    buf = []
                    yield aa, frame, lo, hi
                    if not ok:
                        break   # end of this frame
                    continue
                buf = []
                in_orf = False

            if ok:
                if not in_orf and a == _M:
                    start_pos = saved_pos
                    in_orf = True
                if in_orf:
                    buf.append(a)
                if stop and start_after_stop:
                    start_pos = saved_pos
                    in_orf = True
            else:
                break   # IncFrame
