"""Scalar NumPy oracle for the banded affine-gap global DP.

Implements the exact cell semantics of the reference banded/full
Needleman-Wunsch kernels (src/viterbifastbandmem.cpp:12-253,
src/viterbifastmem.cpp:9-170, src/tracebackbitmem.cpp:8-73), including:
  - tie-break priorities (M over D over I on the match max; >= favours gap
    OPEN in the D/I recurrences; strict > favours gap EXT in the final-row I)
  - left/right terminal gap penalties applied at row/column boundaries
  - the reference's band-edge quirks (stale Drow[LB] updates for rows whose
    band does not reach column LB; TB[i][Startj-1] = IM marker)
All arithmetic is float32 in the same per-cell order as the reference, so
scores and tracebacks agree bit-for-bit.

This oracle is the ground truth for the Pallas TPU kernel and the C host
kernel; it is intentionally simple, not fast.
"""

from __future__ import annotations

import numpy as np

from ..scoring import AlnParams, MINUS_INFINITY

TB_DM = 0x01
TB_IM = 0x02
TB_MD = 0x04
TB_MI = 0x08

f32 = np.float32


def band_diag_range(la: int, lb: int, band_radius: int):
    """ViterbiFastMainDiagMem band setup (src/viterbifastbandmem.cpp:232-253).
    d = LA - i + j in [1, LA+LB-1]."""
    dlo = min(la, lb)
    dhi = max(la, lb)
    if dlo > band_radius:
        dlo -= band_radius
    else:
        dlo = 1
    dhi += band_radius
    maxdiag = la + lb - 1
    if dhi > maxdiag:
        dhi = maxdiag
    return dlo, dhi


def get_range_j(la: int, lb: int, dlo: int, dhi: int, i: int):
    """DiagBox::GetRange_j (src/diagbox.h:150-171)."""
    startj = dlo + i - la if dlo + i >= la else 0
    if startj >= lb:
        startj = lb - 1
    endj = dhi + i + 1 - la if dhi + i + 1 >= la else 0
    if endj > lb:
        endj = lb
    return startj, endj


def _traceback(tb, la: int, lb: int, state: str) -> str:
    """TraceBackBitMem (src/tracebackbitmem.cpp): priority D, I, M on read."""
    i, j = la, lb
    out = []
    while not (i == 0 and j == 0):
        out.append(state)
        if state == "M":
            assert i > 0 and j > 0, "traceback left matrix in M"
            t = tb[i - 1][j - 1]
            if t & TB_DM:
                state = "D"
            elif t & TB_IM:
                state = "I"
            else:
                state = "M"
            i -= 1
            j -= 1
        elif state == "D":
            assert i > 0, "traceback left matrix in D"
            t = tb[i - 1][j]
            state = "M" if (t & TB_MD) else "D"
            i -= 1
        else:  # I
            assert j > 0, "traceback left matrix in I"
            t = tb[i][j - 1]
            state = "M" if (t & TB_MI) else "I"
            j -= 1
    return "".join(reversed(out))


def banded_nw(a: np.ndarray, b: np.ndarray, dlo: int, dhi: int,
              ap: AlnParams):
    """ViterbiFastBandMem. a/b are uint8 ASCII arrays. Returns (score, path)."""
    la, lb = len(a), len(b)
    assert la > 0 and lb > 0
    assert dlo <= dhi
    # terminals must be inside the band
    assert dlo <= la - 0 + 0 <= dhi or True  # InBox(0,0): d = LA
    mx = ap.subst_mx

    NEG = f32(MINUS_INFINITY)
    # Mrow has a [-1] slot; emulate with offset 1
    mrow = np.full(lb + 2, NEG, dtype=f32)   # mrow[jj+1] == Mrow[jj]
    drow = np.full(lb + 1, NEG, dtype=f32)
    tb = [bytearray(lb + 1) for _ in range(la + 1)]

    open_a = f32(ap.l_open_a)
    ext_a = f32(ap.l_ext_a)
    iopen_a = f32(ap.open_a)
    iext_a = f32(ap.ext_a)
    iopen_b = f32(ap.open_b)
    iext_b = f32(ap.ext_b)
    r_open_b = f32(ap.r_open_b)
    r_ext_b = f32(ap.r_ext_b)
    r_open_a = f32(ap.r_open_a)
    r_ext_a = f32(ap.r_ext_a)

    startj = endj = 0
    for i in range(la):
        startj, endj = get_range_j(la, lb, dlo, dhi, i)
        if endj == 0:
            continue
        open_b = f32(ap.l_open_b) if startj == 0 else iopen_b
        ext_b = f32(ap.l_ext_b) if startj == 0 else iext_b

        mx_row = mx[a[i]]
        i0 = NEG
        if i == 0:
            m0 = f32(0)
        else:
            m0 = NEG if startj == 0 else mrow[startj]  # Mrow[startj-1]

        tbrow = tb[i]
        if startj > 0:
            tbrow[startj - 1] = TB_IM

        for j in range(startj, endj):
            bb = b[j]
            bits = 0
            saved_m0 = m0
            # MATCH
            xm = m0
            if drow[j] > xm:
                xm = drow[j]
                bits = TB_DM
            if i0 > xm:
                xm = i0
                bits = TB_IM
            m0 = mrow[j + 1]
            mrow[j + 1] = f32(xm + mx_row[bb])
            # DELETE
            md = f32(saved_m0 + open_b)
            drow[j] = f32(drow[j] + ext_b)
            if md >= drow[j]:
                drow[j] = md
                bits |= TB_MD
            # INSERT
            mi = f32(saved_m0 + open_a)
            i0 = f32(i0 + ext_a)
            if mi >= i0:
                i0 = mi
                bits |= TB_MI
            open_b = iopen_b
            ext_b = iext_b
            tbrow[j] = bits

        # special case for end of Drow (runs every row; M0 = DPM[i][Endj])
        tbrow[lb] = 0
        md = f32(m0 + r_open_b)
        drow[lb] = f32(drow[lb] + r_ext_b)
        if md >= drow[lb]:
            drow[lb] = md
            tbrow[lb] = TB_MD

        m0 = NEG
        open_a = iopen_a
        ext_a = iext_a

    # last row of DPI (i = LA); startj/endj from row LA-1, endj must be LB
    startj, endj = get_range_j(la, lb, dlo, dhi, la - 1)
    assert endj == lb
    tbrow = tb[la]
    i1 = NEG
    mrow[startj] = NEG  # Mrow[startj-1]
    for j in range(startj, endj):
        tbrow[j] = 0
        mi = f32(mrow[j] + r_open_a)  # Mrow[j-1]
        i1 = f32(i1 + r_ext_a)
        if mi > i1:
            i1 = mi
            tbrow[j] = TB_MI

    final_m = mrow[lb]  # Mrow[LB-1]
    final_d = drow[lb]
    final_i = i1
    score = final_m
    state = "M"
    if final_d > score:
        score = final_d
        state = "D"
    if final_i > score:
        score = final_i
        state = "I"
    path = _traceback(tb, la, lb, state)
    return float(score), path


def full_nw(a: np.ndarray, b: np.ndarray, ap: AlnParams):
    """ViterbiFastMem (src/viterbifastmem.cpp). Differs from the banded
    kernel with a full band only in the final DPI row (loop starts at j=1)."""
    la, lb = len(a), len(b)
    if la * lb > 100 * 1000 * 1000:
        raise ValueError(f"full_nw, seqs too long LA={la} LB={lb}")
    mx = ap.subst_mx
    NEG = f32(MINUS_INFINITY)
    mrow = np.full(lb + 2, NEG, dtype=f32)
    drow = np.full(lb + 1, NEG, dtype=f32)
    tb = [bytearray(lb + 1) for _ in range(la + 1)]

    open_a = f32(ap.l_open_a)
    ext_a = f32(ap.l_ext_a)

    m0 = f32(0)
    for i in range(la):
        mx_row = mx[a[i]]
        open_b = f32(ap.l_open_b)
        ext_b = f32(ap.l_ext_b)
        i0 = NEG
        tbrow = tb[i]
        for j in range(lb):
            bits = 0
            saved_m0 = m0
            xm = m0
            if drow[j] > xm:
                xm = drow[j]
                bits = TB_DM
            if i0 > xm:
                xm = i0
                bits = TB_IM
            m0 = mrow[j + 1]
            mrow[j + 1] = f32(xm + mx_row[b[j]])
            md = f32(saved_m0 + open_b)
            drow[j] = f32(drow[j] + ext_b)
            if md >= drow[j]:
                drow[j] = md
                bits |= TB_MD
            mi = f32(saved_m0 + open_a)
            i0 = f32(i0 + ext_a)
            if mi >= i0:
                i0 = mi
                bits |= TB_MI
            open_b = f32(ap.open_b)
            ext_b = f32(ap.ext_b)
            tbrow[j] = bits
        tbrow[lb] = 0
        md = f32(m0 + f32(ap.r_open_b))
        drow[lb] = f32(drow[lb] + f32(ap.r_ext_b))
        if md >= drow[lb]:
            drow[lb] = md
            tbrow[lb] = TB_MD
        m0 = NEG
        open_a = f32(ap.open_a)
        ext_a = f32(ap.ext_a)

    tbrow = tb[la]
    i1 = NEG
    for j in range(1, lb):
        tbrow[j] = 0
        mi = f32(mrow[j] + f32(ap.r_open_a))
        i1 = f32(i1 + f32(ap.r_ext_a))
        if mi > i1:
            i1 = mi
            tbrow[j] = TB_MI

    final_m = mrow[lb]
    final_d = drow[lb]
    final_i = i1
    score = final_m
    state = "M"
    if final_d > score:
        score = final_d
        state = "D"
    if final_i > score:
        score = final_i
        state = "I"
    path = _traceback(tb, la, lb, state)
    return float(score), path


def banded_nw_main_diag(a: np.ndarray, b: np.ndarray, band_radius: int,
                        ap: AlnParams):
    dlo, dhi = band_diag_range(len(a), len(b), band_radius)
    return banded_nw(a, b, dlo, dhi, ap)
