"""The plain reference of usearch_global's hole DP, and the least time of a
set of holes on the H100.

A hole is the piece of a chained alignment between two HSPs (or between an
HSP and a sequence end) that the engine aligns whole: its query letters a,
its target letters b, and its class, four bits saying which of its ends
touch an end of the query or the target (1: a's left, 2: b's left, 4: a's
right, 8: b's right), so take the terminal gap penalties there
(src/alnparams.cpp:100-152).  align() aligns each hole with dp.align, the
banded global DP written from USEARCH's, at the engine's band radius and
with its class's penalties; dp.py states the tie rules (M over D over I on
the match, a gap opens rather than extends on equal scores).

hole_bound() is the least time a set of holes can take, from their
lengths and band alone: the larger of 9 float32 operations a band cell
over 67 TFLOP/s and the bytes over 3.35 TB/s (NVIDIA's H100 SXM data
sheet): the letters read once, 4 traceback bits a band cell written once,
the path's share of them read back (half a byte a step, at least max(la,
lb) steps), and a score and 2-bit path codes a step written.

Plain NumPy and PyTorch: nothing here imports the port.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Optional, Sequence

import numpy as np

from . import dp

# the float32 operations of one band cell: the three states' adds and
# compares of the DP's recurrence
OPS_PER_CELL = 9
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# traceback bytes one call of dp.align may hold
TB_BUDGET = 1 << 24


def terminal(cls_bits: int):
    """(left_a, left_b, right_a, right_b) of a hole's class."""
    return tuple(bool(cls_bits & b) for b in (1, 2, 4, 8))


def penalties(scoring: dict, cls_bits: int) -> dp.Penalties:
    s = scoring
    return dp.penalties(s["match"], s["mismatch"], s["open"], s["ext"],
                        s["term_open"], s["term_ext"],
                        terminal=terminal(cls_bits))


def _mirror(cls_bits: int) -> int:
    """The class of the hole with both sequences reversed: left and right
    swap."""
    return ((cls_bits & 3) << 2) | ((cls_bits >> 2) & 3)


def _align_calls(calls):
    """dp.align of each call's (pairs, penalties, radius): [(scores,
    paths)] (a worker's share)."""
    return [dp.align(pairs, pens, radius, traceback=True)
            for pairs, pens, radius in calls]


def align(holes: Sequence, scoring: dict, radius: int,
          from_the_end: bool = False, workers: Optional[int] = None):
    """(scores float32, paths [bytes of M/D/I]) of holes = [(a, b,
    cls_bits)], a and b uint8 letters, aligned in their main-diagonal band
    of `radius`, on `workers` processes (None: one a core).
    from_the_end: the control's DP, which aligns the reversed sequences
    (the mirror class) and reverses the path: the same scores, and of
    several optimal paths the one that dp.py's ties pick from the other
    end."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = len(holes)
    scores = np.zeros(n, np.float32)
    paths = [b""] * n
    if from_the_end:
        holes = [(a[::-1], b[::-1], _mirror(c)) for a, b, c in holes]
    la = np.array([len(h[0]) for h in holes], np.int64)
    lb = np.array([len(h[1]) for h in holes], np.int64)
    width = np.abs(la - lb) + 2 * radius + 1
    # calls of holes alike in length and band, each within the budget
    order = np.lexsort((width, la))
    calls = []
    lo = 0
    while lo < n:
        hi, amax, wmax = lo + 1, la[order[lo]], width[order[lo]]
        while hi < n and (hi + 1 - lo) * max(amax, la[order[hi]]) \
                * max(wmax, width[order[hi]]) <= TB_BUDGET:
            amax = max(amax, la[order[hi]])
            wmax = max(wmax, width[order[hi]])
            hi += 1
        calls.append(order[lo:hi])
        lo = hi
    workers = min(len(calls), workers or len(os.sched_getaffinity(0)))
    shares = [calls[k::workers] for k in range(workers)]
    args = [[([(holes[k][0], holes[k][1]) for k in idx],
              [penalties(scoring, holes[k][2]) for k in idx], radius)
             for idx in share] for share in shares]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            results = pool.map(_align_calls, args)
    else:
        results = [_align_calls(a) for a in args]
    for share, res in zip(shares, results):
        for idx, (sc, ps) in zip(share, res):
            for k, s, p in zip(idx, sc, ps):
                scores[k] = s
                paths[k] = p[::-1] if from_the_end else p
    return scores, paths


def _diag_sum(c, u, v, x):
    """Sum over whole d <= x of min(c, u + d, v - d) where positive:
    the band cells on the diagonals up to x of a rectangle of c = min(la,
    lb), u = la, v = lb (int64 arrays)."""
    def tri(k):          # 1 + 2 + ... + k, k >= 0
        return k * (k + 1) // 2
    # min(c, u + d, v - d) = u + d up to d = c - u, c up to v - c, v - d
    # after, positive on -u < d < v
    x = np.minimum(x, v - 1)
    a = np.minimum(x, c - u)
    out = np.where(a > -u, tri(u + a), 0)
    b = np.minimum(x, v - c)
    out = out + np.where(b > c - u, (b - (c - u)) * c, 0)
    out = out + np.where(x > v - c, tri(c - 1) - tri(v - x - 1), 0)
    return np.where(x > -u, out, 0)


def band_cells(la, lb, radius: int) -> np.ndarray:
    """The cells of each pair's band (dp.band_range): (i, j) in [0, la) x
    [0, lb) with dlo - la <= j - i <= dhi - la."""
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    c = np.minimum(la, lb)
    dlo = np.where(c > radius, c - radius, 1)
    dhi = np.minimum(np.maximum(la, lb) + radius, la + lb - 1)
    return _diag_sum(c, la, lb, dhi - la) - _diag_sum(c, la, lb,
                                                      dlo - la - 1)


def hole_bytes(la, lb, radius: int) -> np.ndarray:
    """The least bytes each hole moves (see the module's docstring)."""
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    steps = np.maximum(la, lb)
    return (la + lb + band_cells(la, lb, radius) / 2 + steps / 2 + 4
            + steps / 4)


def hole_bound(alen, blen, radius: int) -> float:
    """Seconds: the least time of the holes of lengths alen x blen."""
    ops = OPS_PER_CELL * float(band_cells(alen, blen, radius).sum())
    nbytes = float(hole_bytes(alen, blen, radius).sum())
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
