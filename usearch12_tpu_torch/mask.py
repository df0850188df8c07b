"""Low-complexity masking (soft-mask = lowercase).

FastMask (default for both nt and aa DBs, src/fastmask.cpp:90-160):
  - homopolymer runs of length >= 5: lowercase run positions [start+2, end-1]
  - tandem 2-mer arrays (both phases) of length >= 5 pairs-span: lowercase
    [start+2, end-1]
The reference quirks are preserved exactly: the final character of a
terminal homopolymer run is never masked, and the tandem loop has no
end-of-sequence flush, so terminal tandem arrays are unmasked.

MaskSeq with type None upper-cases (src/mask.cpp:52-57).
"""

from __future__ import annotations

import numpy as np

from .alpha import TO_UPPER, IS_LOWER
from .config import options

MT_NONE = "none"
MT_FASTNUCLEO = "fastnucleo"
MT_FASTAMINO = "fastamino"
MT_DUST = "dust"
MT_SEG = "seg"
MT_USER = "user"
MT_DEFAULT = "default"


def _tolower(c: int) -> int:
    return c + 32 if ord("A") <= c <= ord("Z") else c


def fast_mask(seq: np.ndarray, nucleo: bool) -> np.ndarray:
    """src/fastmask.cpp FastMaskSeq. Returns a new uint8 array."""
    hardmask = options().flag("hardmask")
    hard_char = ord("N") if nucleo else ord("X")
    L = len(seq)
    out = TO_UPPER[seq].copy()
    if L < 2:
        return out

    from .native import get_lib
    lib = get_lib()
    if lib is not None:
        up = np.ascontiguousarray(TO_UPPER[seq])
        lib.fast_mask_c(up.ctypes.data, out.ctypes.data, L,
                        int(hardmask), hard_char)
        return out

    k1, j1 = 5, 2
    k2, j2 = 5, 1

    # the reference masks IN PLACE (MaskSeq(Seq,L,Type,Seq)), so with
    # -hardmask later passes read 'N's written by earlier ones —
    # comparisons read toupper() of the EVOLVING buffer
    # homopolymer runs
    lastc = -1
    start = -1  # reference uses UINT_MAX; first check yields tiny n1
    for i in range(L):
        c = int(TO_UPPER[out[i]])
        if c != lastc or i + 1 == L:
            n1 = i - start if start >= 0 else i + 1  # i - UINT_MAX == i+1 (mod 2^32)
            if n1 >= k1 and start >= 0:
                lo = start + j1
                if hardmask:
                    out[lo:i] = hard_char
                else:
                    for j in range(lo, i):
                        out[j] = _tolower(int(out[j]))
            start = i
        lastc = c

    # tandem 2-mers, phases 0 and 1; NOTE: no end-of-loop flush (reference)
    for start_pos in (0, 1):
        last_pair = -1
        start = -(10 ** 9)  # UINT_MAX sentinel; n2 check below guards it
        for i in range(start_pos, L - 1, 2):
            c1 = int(TO_UPPER[out[i]])
            c2 = int(TO_UPPER[out[i + 1]])
            pair = (c1 << 8) + c2
            if pair != last_pair:
                n2 = i - start
                if start >= 0 and n2 >= k2:
                    lo = start + 2 * j2
                    if hardmask:
                        out[start + j2:i] = hard_char
                    else:
                        for j in range(lo, i):
                            out[j] = _tolower(int(out[j]))
                start = i
            last_pair = pair
    return out


def mask_seq(seq: np.ndarray, mtype: str, nucleo: bool) -> np.ndarray:
    mtype = mtype.lower()
    if mtype in (MT_NONE,):
        return TO_UPPER[seq].copy()
    if mtype == MT_FASTNUCLEO or (mtype == MT_DEFAULT and nucleo):
        return fast_mask(seq, True)
    if mtype == MT_FASTAMINO or (mtype == MT_DEFAULT and not nucleo):
        return fast_mask(seq, False)
    if mtype == MT_USER:
        return seq.copy()
    if mtype == MT_DUST:
        from .dust import dust_mask
        return dust_mask(seq)
    if mtype == MT_SEG:
        from .seg import seg_mask
        return seg_mask(seq)
    raise ValueError(f"invalid mask type '{mtype}'")


def db_mask_type(nucleo: bool) -> str:
    """MaskDB default resolution (src/makeudb.cpp:11-25)."""
    s = options().str("dbmask", "")
    if s == "" or s.lower() == "default":
        return MT_FASTNUCLEO if nucleo else MT_FASTAMINO
    return s.lower()
