"""SEG low-complexity amino-acid masking (usearch12 src/segmaskseq.cpp,
the classic Wootton & Federhen SEG).

Parameters fixed as in the reference: window 12, locut 2.2, hicut 2.5,
maxtrim 100, overlaps off, hilenmin 0.  Constants that matter for
float-exact parity:
  - LN2 is the TRUNCATED 0.693147 (src/segmask.h:24), not M_LN2;
  - lnfac[] (src/lnfrac.cpp) is lgamma(n+1) rounded to 6 decimals.

IMPORTANT divergence from the published source, established by probing
the 12.0-beta binary with crafted inputs (300/300 byte-exact): the
binary counts EVERY character into the composition, with letters
outside the 20-letter alphabet bucketed into class 0 (the 'A' slot) —
i.e. its aaindex defaults to 0 and there is no aaflag gating.  A
window's total is therefore always the window length, so the entropy
always takes the entray path and getprob's total is the window length.
Soft mask lowercases; -hardmask writes lowercase 'x'
(src/segmaskseq.cpp:642-659).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .config import options

W = 12
LOCUT = 2.2
HICUT = 2.5
MAXTRIM = 100
DOWNSET = (W + 1) // 2 - 1   # 5
UPSET = W - DOWNSET          # 7
LN2 = 0.693147               # truncated constant (src/segmask.h:24)
LN20 = 2.9957322735539909

_AA = "ACDEFGHIKLMNPQRSTVWY"
# aaindex: 20 canonical aa chars (either case) -> 0..19; everything else
# -> 0 (the binary's bucketing; see module docstring)
AAINDEX = np.zeros(256, dtype=np.int32)
for _i, _c in enumerate(_AA):
    AAINDEX[ord(_c)] = _i
    AAINDEX[ord(_c.lower())] = _i

ENTRAY = [0.0] * (W + 1)
for _i in range(1, W + 1):
    _x = _i / float(W)
    ENTRAY[_i] = -_x * math.log(_x) / LN2


class _LnFac:
    """lnfac[n] = lgamma(n+1) rounded to 6 decimals (src/lnfrac.cpp's
    table; extended on demand past its 10001 entries)."""

    def __init__(self) -> None:
        self._tab = [round(math.lgamma(n + 1), 6) for n in range(256)]

    def __getitem__(self, n: int) -> float:
        t = self._tab
        while n >= len(t):
            t.append(round(math.lgamma(len(t) + 1), 6))
        return t[n]


LNFAC = _LnFac()


def _state_of(comp: List[int]) -> List[int]:
    """stateon: composition counts sorted descending, zero padded."""
    nz = sorted((c for c in comp if c), reverse=True)
    return nz + [0] * (22 - len(nz))


def _entropy_h(comp: List[int]) -> float:
    """Window entropy: sum(entray[c]) over the class counts (total is
    always W because every character is counted)."""
    ent = 0.0
    for c in sorted((c for c in comp if c), reverse=True):
        ent += ENTRAY[c]
    return ent


def _lnass(sv: List[int]) -> float:
    """src/segmaskseq.cpp:54-91."""
    ans = LNFAC[20]
    if sv[0] == 0:
        return ans
    total = 20
    cls = 1
    svim1 = sv[0]
    i = 0
    idx = 0
    while True:
        i += 1
        if i == 20:
            ans -= LNFAC[cls]
            break
        idx += 1
        svi = sv[idx]
        if svi == svim1:
            cls += 1
            svim1 = svi
            continue
        total -= cls
        ans -= LNFAC[cls]
        if svi == 0:
            ans -= LNFAC[total]
            break
        cls = 1
        svim1 = svi
    return ans


def _getprob(sv: List[int], total: int) -> float:
    ans = LNFAC[total]
    for c in sv:
        if c == 0:
            break
        ans -= LNFAC[c]
    return _lnass(sv) + ans - float(total) * LN20


def _seqent(seq: np.ndarray) -> Optional[List[float]]:
    """Sliding window-12 entropies; H[i] covers the window starting at
    i-DOWNSET; -1 outside [DOWNSET, len-UPSET]."""
    L = len(seq)
    if W > L:
        return None
    H = [-1.0] * L
    comp = [0] * 20
    for k in range(W):
        comp[AAINDEX[seq[k]]] += 1
    first = DOWNSET
    last = L - UPSET
    start = 0
    for i in range(first, last + 1):
        H[i] = _entropy_h(comp)
        if start + W < L:
            comp[AAINDEX[seq[start]]] -= 1
            comp[AAINDEX[seq[start + W]]] += 1
            start += 1
    return H


def _findlo(i: int, limit: int, H: List[float]) -> int:
    j = i
    while j >= limit:
        if H[j] == -1:
            break
        if H[j] > HICUT:
            break
        j -= 1
    return j + 1


def _findhi(i: int, limit: int, H: List[float]) -> int:
    j = i
    while j <= limit:
        if H[j] == -1:
            break
        if H[j] > HICUT:
            break
        j += 1
    return j - 1


def _trim(seq: np.ndarray, leftend: int, rightend: int) -> Tuple[int, int]:
    """src/segmaskseq.cpp:118-175: shrink [leftend,rightend] to the
    min-probability subwindow (published semantics — all the probed
    'recursion shrink' behavior turned out to live in mergesegs'
    local-length clamp, see _mergesegs)."""
    sub = seq[leftend:rightend + 1]
    L = len(sub)
    minlen = 1
    if L - MAXTRIM > minlen:
        minlen = L - MAXTRIM
    lend = 0
    rend = L - 1
    minprob = 1.0
    for ln in range(L, minlen, -1):
        comp = [0] * 20
        for k in range(ln):
            comp[AAINDEX[sub[k]]] += 1
        i = 0
        while True:
            prob = _getprob(_state_of(comp), ln)
            if prob < minprob:
                minprob = prob
                lend = i
                rend = ln + i - 1
            if i + 1 + ln > L:
                break
            comp[AAINDEX[sub[i]]] -= 1
            comp[AAINDEX[sub[i + ln]]] += 1
            i += 1
    return leftend + lend, rightend - (L - rend - 1)


def _segseq(seq: np.ndarray, offset: int, segs: List[List[int]]) -> None:
    """src/segmaskseq.cpp:546-612 (recursive, published semantics —
    including the mergesegs local-length clamp bug, see _mergesegs)."""
    H = _seqent(seq)
    if H is None:
        return
    L = len(seq)
    first = DOWNSET
    last = L - UPSET
    lowlim = first
    i = first
    while i <= last:
        if H[i] <= LOCUT and H[i] != -1:
            loi = _findlo(i, lowlim, H)
            hii = _findhi(i, last, H)
            leftend = loi - DOWNSET
            rightend = hii + UPSET - 1
            leftend, rightend = _trim(seq, leftend, rightend)
            if i + UPSET - 1 < leftend:
                lend = loi - DOWNSET
                rend = leftend - 1
                leftsegs: List[List[int]] = []
                # openwin(seq, lend, rend-lend+1): INCLUSIVE [lend,rend]
                # (src/segmaskseq.cpp:586-589)
                _segseq(seq[lend:rend + 1], offset + lend, leftsegs)
                segs.extend(leftsegs)
            segs.append([leftend + offset, rightend + offset])
            i = min(hii, rightend + DOWNSET)
            lowlim = i + 1
        i += 1
    _mergesegs(segs, L)


def _mergesegs(segs: List[List[int]], seq_len: int) -> None:
    """src/segmaskseq.cpp:494-534 (overlaps=false, hilenmin=0): join
    overlapping segments (the C keeps nextseg's end verbatim), then the
    trailing-fixup `if (seq->length - seg->end - 1 < hilenmin)
    seg->end = seq->length - 1` (:531-533).  In a recursive segseq call
    this compares the sub-window's LOCAL length against the last
    segment's GLOBAL end — a genuine bug in the published source that
    the binary exhibits: any recursion's last segment whose global end
    reaches past the sub-window length gets clamped to length-1, often
    to a degenerate begin>end span that masks nothing.  This single
    mechanism reproduces every probed 'recursion right-end shrink'
    (tools/seg_probe.py, tools/seg_fuzz.py): a one-segment recursion
    looks shrunk-by-offset; a multi-segment recursion looks published
    with an invisible clamped final segment; the 109-char ILFPDMND
    probe's lone masked 'l' is its seg [40,71] clamped to [40,40]."""
    k = 0
    while k + 1 < len(segs):
        if segs[k][1] >= segs[k + 1][0]:
            segs[k][1] = segs[k + 1][1]
            del segs[k + 1]
            continue
        k += 1
    if segs and seq_len - segs[-1][1] - 1 < 0:
        segs[-1][1] = seq_len - 1


def seg_mask(seq: np.ndarray) -> np.ndarray:
    """SegMaskSeq (src/segmaskseq.cpp:633-662)."""
    o = options()
    hardmask = o.flag("hardmask")
    segs: List[List[int]] = []
    _segseq(seq, 0, segs)
    from .alpha import TO_UPPER
    out = TO_UPPER[seq].copy()
    for lo, hi in segs:
        if hardmask:
            out[lo:hi + 1] = ord("x")   # lowercase 'x' (reference quirk)
        else:
            for i in range(lo, hi + 1):
                c = out[i]
                if ord("A") <= c <= ord("Z"):
                    out[i] = c + 32
    return out
