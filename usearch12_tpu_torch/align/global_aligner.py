"""HSP-anchored global alignment (src/globalalignmem.cpp:25-236).

global_align = chained global HSPs (trivial M runs) + banded NW in the holes
between/around them.  Falls back to a full-pair banded NW when no HSPs and
-gaforce; fails (returns None) when HSP fract-id is below the heuristic
threshold, exactly matching GlobalAlign_AllOpts' gating (these rules gate
output parity).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..scoring import AlnParams, AlnHeuristics
from .hsp import HSPFinder, HSP
from .oracle import banded_nw_main_diag, full_nw


def _align_hole(a, b, hole: HSP, la, lb, ap: AlnParams, ah: AlnHeuristics,
                kernel=None) -> str:
    """AlignHSPMem (src/globalalignmem.cpp:70-112)."""
    sla, slb = hole.leni, hole.lenj
    if sla == 0:
        return "I" * slb
    if slb == 0:
        return "D" * sla
    local_ap = ap.hole_params(hole.left_a(), hole.left_b(),
                              hole.right_a(la), hole.right_b(lb))
    sub_a = a[hole.loi:hole.loi + sla]
    sub_b = b[hole.loj:hole.loj + slb]
    if kernel is not None:
        return kernel(sub_a, sub_b, local_ap, ah.band_radius)
    if ah.band_radius == 0:
        _, path = full_nw(sub_a, sub_b, local_ap)
    else:
        _, path = banded_nw_main_diag(sub_a, sub_b, ah.band_radius, local_ap)
    return path


def _get_hole(h1: Optional[HSP], h2: Optional[HSP], la: int, lb: int) -> HSP:
    """GetHole (src/globalalignmem.cpp:25-68)."""
    if h1 is not None and h2 is not None:
        loi = h1.hii + 1
        loj = h1.hij + 1
        return HSP(loi, loj, h2.loi - h1.hii - 1, h2.loj - h1.hij - 1)
    if h1 is None:
        return HSP(0, 0, h2.loi, h2.loj)
    loi = h1.hii + 1
    loj = h1.hij + 1
    return HSP(loi, loj, la - loi, lb - loj)


def global_align(a: np.ndarray, b: np.ndarray, ap: AlnParams,
                 ah: AlnHeuristics, hf: HSPFinder,
                 full_dp_always: bool = False, fail_if_no_hsps: bool = True,
                 hole_kernel=None) -> Optional[str]:
    """GlobalAlign_AllOpts (src/globalalignmem.cpp:129-236).
    Returns path string or None if not aligned.  `hf` must have set_a/set_b
    already applied.  `hole_kernel(sub_a, sub_b, local_ap, band)` optionally
    overrides the hole DP (e.g. batched device kernel)."""
    la, lb = len(a), len(b)

    if full_dp_always:
        _, path = full_nw(a, b, ap)
        return path

    min_hsp_length = 32 if ah.min_global_hsp_length == 0 else ah.min_global_hsp_length
    if min_hsp_length > la // 4:
        min_hsp_length = la // 4
    if min_hsp_length < 16:
        min_hsp_length = 16

    chained, hsp_fract_id = hf.get_global_hsps(min_hsp_length)
    if hsp_fract_id < ah.min_global_hsp_fract_id and fail_if_no_hsps:
        return None
    if len(chained) == 0:
        if ah.min_global_hsp_length > 0 and la > 64 and fail_if_no_hsps:
            return None
        if ah.band_radius == 0:
            _, path = full_nw(a, b, ap)
        else:
            _, path = banded_nw_main_diag(a, b, ah.band_radius, ap)
        return path

    parts = []
    for i, hsp in enumerate(chained):
        prev = chained[i - 1] if i > 0 else None
        hole = _get_hole(prev, hsp, la, lb)
        parts.append(_align_hole(a, b, hole, la, lb, ap, ah, hole_kernel))
        if hsp.leni != hsp.lenj:
            return None
        parts.append("M" * hsp.length())
    hole = _get_hole(chained[-1], None, la, lb)
    parts.append(_align_hole(a, b, hole, la, lb, ap, ah, hole_kernel))
    return "".join(parts)
