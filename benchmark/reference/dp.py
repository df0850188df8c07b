"""Banded affine-gap global alignment in plain NumPy: the reference's
alignment of a query against a candidate.

Written from USEARCH's banded global DP (src/viterbifastbandmem.cpp:12-253,
src/tracebackbitmem.cpp:8-73), not from the port.  a (length la) runs down
the rows, b (length lb) across.  Three states: M (a[i] against b[j]), D
(a[i] against a gap) and I (b[j] against a gap); D and I open only from M,
M follows any state.  A gap before the first letter of the other sequence
takes the left terminal penalties, one after its last letter the right
ones, every other gap the interior ones; a run of n gap columns costs open
+ (n - 1) * ext.  The band holds the cells with dlo <= la - i + j <= dhi
(band_range, ViterbiFastMainDiagMem's).  Ties: M is kept over D, D over I
on the match; a gap opens rather than extends on equal scores; in the
final row past a's end an I extends on equal scores; the final score
prefers M, then D, then I.

The pairs of a call are computed together, one row at a time, in band
coordinates: cell (i, k) is column j = i + (dlo - la) + k, so the
diagonal predecessor has the same k in the row above, the vertical one
k + 1 there and the horizontal one k - 1 in the same row.  With scores
that are multiples of 0.5 every float32 sum is exact, so the order of
the additions does not change a score.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

NEG = np.float32(-np.inf)
TB_DM, TB_IM, TB_MD, TB_MI = 1, 2, 4, 8
OPS = np.frombuffer(b"MDI", np.uint8)
# letters compare without case: a database's mask lowercases letters
UPPER = np.arange(256, dtype=np.uint8)
UPPER[97:123] -= 32


class Penalties(NamedTuple):
    """Scores added per column (gap penalties are negative)."""
    match: float
    mismatch: float
    open_a: float
    ext_a: float
    open_b: float
    ext_b: float
    l_open_a: float
    l_ext_a: float
    l_open_b: float
    l_ext_b: float
    r_open_a: float
    r_ext_a: float
    r_open_b: float
    r_ext_b: float


def penalties(match: float, mismatch: float, open_: float, ext: float,
              term_open: float, term_ext: float,
              terminal=(True, True, True, True)) -> Penalties:
    """USEARCH's nucleotide scoring (Init4: interior open/ext, terminal
    open/ext); `terminal` = (left_a, left_b, right_a, right_b) says which
    ends take the terminal penalties: a piece of an alignment that does
    not touch a sequence end takes interior ones there."""
    la_, lb_, ra_, rb_ = terminal
    return Penalties(
        match, mismatch, open_, ext, open_, ext,
        term_open if la_ else open_, term_ext if la_ else ext,
        term_open if lb_ else open_, term_ext if lb_ else ext,
        term_open if ra_ else open_, term_ext if ra_ else ext,
        term_open if rb_ else open_, term_ext if rb_ else ext)


def band_range(la: int, lb: int, radius: int):
    """(dlo, dhi) of the main-diagonal band of radius `radius`
    (src/viterbifastbandmem.cpp:232-253)."""
    dlo, dhi = min(la, lb), max(la, lb)
    dlo = dlo - radius if dlo > radius else 1
    return dlo, min(dhi + radius, la + lb - 1)


def align(pairs: Sequence, pens: Sequence[Penalties], radius: int,
          traceback: bool = False):
    """Scores (float32), and paths (bytes of M/D/I) where traceback, of
    (a, b) uint8 letter pairs, pens[p] the penalties of pair p."""
    n = len(pairs)
    if n == 0:
        return np.zeros(0, np.float32), ([] if traceback else None)
    la = np.array([len(a) for a, _ in pairs], np.int64)
    lb = np.array([len(b) for _, b in pairs], np.int64)
    if la.min() < 1 or lb.min() < 1:
        raise ValueError("empty sequence")
    rng = np.array([band_range(x, y, radius) for x, y in zip(la, lb)])
    off = rng[:, 0] - la                      # j - i at k = 0
    width = rng[:, 1] - rng[:, 0] + 1
    wmax, amax, bmax = int(width.max()), int(la.max()), int(lb.max())
    A = np.zeros((n, amax), np.uint8)
    B = np.zeros((n, bmax), np.uint8)
    for p, (a, b) in enumerate(pairs):
        A[p, :len(a)] = UPPER[np.asarray(a)]
        B[p, :len(b)] = UPPER[np.asarray(b)]
    P = {f: np.array([getattr(x, f) for x in pens], np.float32)[:, None]
         for f in Penalties._fields}
    rows = np.arange(n)[:, None]
    kk = np.arange(wmax)[None, :]
    kf = kk.astype(np.float32)
    negcol = np.full((n, 1), NEG, np.float32)
    Mp = np.full((n, wmax), NEG, np.float32)
    Dp = np.full((n, wmax + 1), NEG, np.float32)
    Dlb = np.full(n, NEG, np.float32)
    fin = np.full((3, n), NEG, np.float32)
    if traceback:
        tb = np.zeros((n, amax, wmax), np.uint8)
        tb_lb = np.zeros((n, amax), np.uint8)
        tb_fin = np.zeros((n, bmax), np.uint8)
    for i in range(amax):
        act = i < la
        j = i + off[:, None] + kk
        valid = act[:, None] & (kk < width[:, None]) & (j >= 0) \
            & (j < lb[:, None])
        s = np.where(A[:, i][:, None] == B[rows, np.clip(j, 0, bmax - 1)],
                     P["match"], P["mismatch"])
        if i == 0:
            mdiag = np.where(j == 0, np.float32(0), NEG)
        else:
            mdiag = Mp
        mdiag = np.where(valid, mdiag, NEG).astype(np.float32)
        dab = Dp[:, 1:]
        at0 = j == 0
        d_ext = dab + np.where(at0, P["l_ext_b"], P["ext_b"])
        d_open = mdiag + np.where(at0, P["l_open_b"], P["open_b"])
        md = d_open >= d_ext
        Dc = np.where(md, d_open, d_ext)
        oa, ea = (P["l_open_a"], P["l_ext_a"]) if i == 0 \
            else (P["open_a"], P["ext_a"])
        i_open = mdiag + oa
        # I[k] = max(I[k - 1] + ext, open[k]) as a running maximum
        Ic = np.maximum.accumulate(i_open - kf * ea, axis=1) + kf * ea
        ileft = np.concatenate([negcol, Ic[:, :-1]], 1)
        mi = i_open >= ileft + ea
        dm = dab > mdiag
        best = np.where(dm, dab, mdiag)
        im = ileft > best
        best = np.where(im, ileft, best)
        Mc = np.where(valid, best + s, NEG)
        Dc = np.where(valid, Dc, NEG)
        # the D column past b's end, from M[i - 1][lb - 1]
        kp = lb - i - off
        ok = (i > 0) & (kp >= 0) & (kp < width)
        m_last = np.where(ok, Mp[np.arange(n), np.clip(kp, 0, wmax - 1)],
                          NEG)
        e = Dlb + P["r_ext_b"][:, 0]
        o = m_last + P["r_open_b"][:, 0]
        lb_open = o >= e
        Dlb = np.where(act, np.where(lb_open, o, e), Dlb).astype(np.float32)
        if traceback:
            tb[:, i, :] = np.where(valid, (dm & ~im) * TB_DM + im * TB_IM
                                   + md * TB_MD + mi * TB_MI, 0)
            tb_lb[:, i] = lb_open * TB_MD
        last = act & (i == la - 1)
        if last.any():
            kl = lb - 1 - i - off
            fin[0, last] = Mc[np.arange(n), np.clip(kl, 0, wmax - 1)][last]
            fin[1, last] = Dlb[last]
            # the row of I past a's end, from M[la - 1][j - 1]
            mprev = np.concatenate([negcol, Mc[:, :-1]], 1)
            f_open = mprev + P["r_open_a"]
            If = np.full(n, NEG, np.float32)
            for k in range(wmax):
                ext = If + P["r_ext_a"][:, 0]
                take = f_open[:, k] > ext
                col_ok = valid[:, k] & last
                If = np.where(col_ok, np.where(take, f_open[:, k], ext), If)
                if traceback:
                    jj = np.clip(i + off + k, 0, bmax - 1)
                    sel = np.nonzero(col_ok)[0]
                    tb_fin[sel, jj[sel]] = take[sel] * TB_MI
            fin[2, last] = If[last]
        Mp = Mc
        Dp = np.concatenate([Dc, negcol], 1)
    state = np.zeros(n, np.int64)
    score = fin[0].copy()
    state[fin[1] > score] = 1
    score = np.maximum(score, fin[1])
    state[fin[2] > score] = 2
    score = np.maximum(score, fin[2])
    if not traceback:
        return score, None
    return score, _traceback(tb, tb_lb, tb_fin, la, lb, off, state)


def _traceback(tb, tb_lb, tb_fin, la, lb, off, state):
    """Paths of all pairs, walked back together from (la, lb)."""
    n = len(la)
    i, j, s = la.copy(), lb.copy(), state.copy()
    out = np.zeros((n, int((la + lb).max())), np.uint8)
    pos = np.zeros(n, np.int64)
    wmax = tb.shape[2]
    p = np.arange(n)
    while True:
        act = (i > 0) | (j > 0)
        if not act.any():
            break
        out[p[act], pos[act]] = OPS[s[act]]
        pos += act
        im, id_, ii = act & (s == 0), act & (s == 1), act & (s == 2)
        # M: the bits of cell (i - 1, j - 1)
        k = np.clip(j - i - off, 0, wmax - 1)
        bm = tb[p, np.clip(i - 1, 0, None), k]
        # D: cell (i - 1, j), or the column past b's end
        kd = np.clip(j - (i - 1) - off, 0, wmax - 1)
        bd = np.where(j == lb, tb_lb[p, np.clip(i - 1, 0, None)],
                      tb[p, np.clip(i - 1, 0, None), kd])
        # I: cell (i, j - 1), or the row past a's end
        ki = np.clip(j - 1 - i - off, 0, wmax - 1)
        bi = np.where(i == la, tb_fin[p, np.clip(j - 1, 0, None)],
                      tb[p, np.clip(i, 0, tb.shape[1] - 1), ki])
        ns = s.copy()
        ns[im] = np.where(bm[im] & TB_DM, 1, np.where(bm[im] & TB_IM, 2, 0))
        ns[id_] = np.where(bd[id_] & TB_MD, 0, 1)
        ns[ii] = np.where(bi[ii] & TB_MI, 0, 2)
        i = i - (im | id_)
        j = j - (im | ii)
        s = ns
    return [out[q, :pos[q]][::-1].tobytes() for q in range(n)]


def path_score(a: np.ndarray, b: np.ndarray, path: bytes,
               pen: Penalties):
    """The score of an alignment path under these semantics, or None when
    the path does not consume exactly a and b."""
    ops = np.frombuffer(path, np.uint8)
    a, b = UPPER[np.asarray(a)], UPPER[np.asarray(b)]
    is_m, is_d, is_i = ops == 77, ops == 68, ops == 73
    if not (is_m | is_d | is_i).all() or \
            int((is_m | is_d).sum()) != len(a) or \
            int((is_m | is_i).sum()) != len(b):
        return None
    qa = np.cumsum(is_m | is_d) - (is_m | is_d)
    tb = np.cumsum(is_m | is_i) - (is_m | is_i)
    eq = a[qa[is_m]] == b[tb[is_m]]
    total = float(eq.sum()) * pen.match + float((~eq).sum()) * pen.mismatch
    starts = np.nonzero(np.concatenate(([True], ops[1:] != ops[:-1])))[0]
    ends = np.concatenate((starts[1:], [len(ops)]))
    for s0, e0 in zip(starts.tolist(), ends.tolist()):
        op = ops[s0]
        if op == 77:
            continue
        if op == 68:
            at, end = int(tb[s0]), len(b)
            side = ("l_open_b", "l_ext_b") if at == 0 else \
                ("r_open_b", "r_ext_b") if at == end else ("open_b", "ext_b")
        else:
            at, end = int(qa[s0]), len(a)
            side = ("l_open_a", "l_ext_a") if at == 0 else \
                ("r_open_a", "r_ext_a") if at == end else ("open_a", "ext_a")
        total += getattr(pen, side[0]) + (e0 - s0 - 1) * getattr(pen, side[1])
    return total


def row_fields(a: np.ndarray, b: np.ndarray, path: bytes):
    """USEARCH's blast6 numbers of a global alignment path (src/
    blast6out.cpp, src/arscorer.cpp:554-569): (percent identity, columns
    from the first to the last M, mismatches, gap opens in those
    columns), identity = identical M columns / those columns."""
    ops = np.frombuffer(path, np.uint8)
    a, b = UPPER[np.asarray(a)], UPPER[np.asarray(b)]
    is_m = ops == 77
    cols = np.nonzero(is_m)[0]
    first, last = int(cols[0]), int(cols[-1])
    qa = np.cumsum(is_m | (ops == 68)) - (is_m | (ops == 68))
    tb = np.cumsum(is_m | (ops == 73)) - (is_m | (ops == 73))
    ids = int((a[qa[is_m]] == b[tb[is_m]]).sum())
    alnlen = last - first + 1
    seg = is_m[first:last + 1]
    opens = int((~seg[1:] & seg[:-1]).sum())
    return 100.0 * (ids / alnlen), alnlen, len(cols) - ids, opens


def blast6_row(qlabel: str, tlabel: str, a, b, path: bytes) -> str:
    """The blast6 line of a global hit (plus strand, whole sequences)."""
    pid, alnlen, mism, opens = row_fields(a, b, path)
    return (f"{qlabel}\t{tlabel}\t{pid:.1f}\t{alnlen}\t{mism}\t{opens}"
            f"\t1\t{len(a)}\t1\t{len(b)}\t*\t*")
