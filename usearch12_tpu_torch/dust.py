"""DUST low-complexity nucleotide masking (usearch12 src/duster.h,
src/dustmask.cpp).

The computation runs in the native library (dust_mask_c); this wrapper
handles option lookup.  Unlike fast masking, dust leaves unmasked bytes
in their original case (DustMask memcpy's the input, duster.h:107).
"""

from __future__ import annotations

import numpy as np

from .config import options


def dust_mask(seq: np.ndarray) -> np.ndarray:
    from .native import get_lib
    lib = get_lib()
    if lib is None:
        raise SystemExit("dust masking requires the native library")
    hardmask = options().flag("hardmask")
    out = np.ascontiguousarray(seq, dtype=np.uint8).copy()
    src = np.ascontiguousarray(seq, dtype=np.uint8)
    lib.dust_mask_c(src.ctypes.data, len(seq), out.ctypes.data,
                    int(hardmask))
    return out
