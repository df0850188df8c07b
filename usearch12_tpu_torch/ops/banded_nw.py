"""Row-sweep banded NW on the card: the device oracle.

Port of usearch12_tpu/ops/banded_nw.py.  BandedNWDevice aligns pairs in
their main-diagonal band (or a band given per pair) with two kernels of
csrc/banded_nw.cu: banded_nw_fwd(), the forward DP one row after another,
and banded_nw_chase(), the final DPI row, the final state and the pointer
chase.  On a CPU tensor each wrapper runs its plain PyTorch version
(banded_nw_fwd_plain(), banded_nw_chase_plain()).  Scores and paths equal
align/oracle.py:banded_nw bit for bit for any gap penalties: the insert
state runs as the oracle's sequential recurrence, where the TPU kernel's
doubling scan was exact only for dyadic penalties.

Its role is the one the JAX package gives it (and the reference's CMP
build and ChainBrute play): a second, simpler implementation of the DP
on the device, to judge the shipped kernels (TorchWaveAligner) on every
pair of a batch where the host oracle is too slow for more than a sample.

The traceback layouts are documented in csrc/banded_nw.cu; none of the
TPU's rotating frame, pre-shifted B or padding to 8 pairs x 128 rows is
kept.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..align.oracle import band_diag_range
from .wavefront_nw import gap_params, match_mismatch, pack_letters
from .wavefront_trace import NEG, TB_DM, TB_IM, TB_MD, TB_MI, check_tensor

BAND_LANES = 126          # widest band, as in the JAX package
OP_M, OP_D, OP_I, OP_PAD = 0, 1, 2, 3
_STATES = np.array(["M", "D", "I"])
_OPS_ASCII = np.frombuffer(b"MDI\0", dtype=np.uint8)


@dataclass
class PairBatch:
    """Letter classes and band geometry of P pairs (host arrays)."""
    a_let: np.ndarray     # (P, max la) uint8
    b_let: np.ndarray     # (P, max lb) uint8
    la: np.ndarray        # (P,) int32
    lb: np.ndarray        # (P,) int32
    dlo: np.ndarray       # (P,) int32
    bw: np.ndarray        # (P,) int32  band width dhi - dlo + 1


def check_bands(la, lb, dlo, bw) -> Tuple[int, int, int]:
    """Raise ValueError unless every pair is non-empty and its band holds
    the start and end cells (1 <= dlo <= min(la, lb), dhi >= max(la, lb))
    and is at most BAND_LANES wide.  Returns (max la, widest band, longest
    la + lb)."""
    if la.numel() == 0:
        raise ValueError("no pairs")
    la, lb, dlo, bw = (x.to(torch.int64) for x in (la, lb, dlo, bw))
    (la_min, lb_min, dlo_min, lo_gap, hi_gap, la_max, bw_max,
     steps) = torch.stack([
         la.min(), lb.min(), dlo.min(), (torch.minimum(la, lb) - dlo).min(),
         (dlo + bw - 1 - torch.maximum(la, lb)).min(), la.max(), bw.max(),
         (la + lb).max()]).tolist()
    if bw_max > BAND_LANES:
        raise ValueError(f"band width {bw_max} exceeds {BAND_LANES} lanes")
    if min(la_min, lb_min, dlo_min) < 1 or lo_gap < 0 or hi_gap < 0:
        raise ValueError("each band must hold the alignment's start and "
                         "end cells (1 <= dlo <= min(la, lb), "
                         "dhi >= max(la, lb))")
    return la_max, bw_max, steps


def pack_pairs(pairs: Sequence, nucleo: bool, band_radius: int
               ) -> PairBatch:
    """pairs: (a, b) or (a, b, dlo, dhi) ASCII uint8 arrays; the band
    defaults to the main-diagonal band (ViterbiFastMainDiagMem)."""
    if not nucleo:
        raise ValueError("BandedNWDevice scores nucleotides only")
    geo = np.array([(len(p[0]), len(p[1])) + (
        tuple(p[2:4]) if len(p) >= 4 else band_diag_range(
            len(p[0]), len(p[1]), band_radius)) for p in pairs],
        np.int64).reshape(-1, 4)
    la, lb, dlo = geo[:, 0], geo[:, 1], geo[:, 2]
    bw = geo[:, 3] - dlo + 1
    check_bands(*(torch.from_numpy(x) for x in (la, lb, dlo, bw)))
    a_let, b_let = pack_letters(pairs, la, lb)
    return PairBatch(a_let, b_let,
                     *(x.astype(np.int32) for x in (la, lb, dlo, bw)))


def _check_inputs(name, dev, P, la, lb, dlo, bw, gp):
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    check_tensor("gp", gp, torch.float32, 1, dev, 16)
    for n, x in (("la", la), ("lb", lb), ("dlo", dlo), ("bw", bw)):
        check_tensor(n, x, torch.int32, 1, dev, P)
    return check_bands(la, lb, dlo, bw)


def banded_nw_fwd(a_let, b_let, la, lb, dlo, bw, gp, match: float,
                  mismatch: float, with_traceback: bool = True):
    """Forward DP of P >= 1 pairs, one row after another.

    a_let (P, amax), b_let (P, bmax) uint8 letter classes; la, lb, dlo,
    bw (P,) int32; gp (16,) float32 gap penalties.  Returns (tb
    (P, amax, W + 1) uint8 or None without traceback, mlast (P, W)
    float32, dlb (P,) float32), W the widest band; layouts in
    csrc/banded_nw.cu."""
    dev = a_let.device
    P = a_let.shape[0]
    check_tensor("a_let", a_let, torch.uint8, 2, dev)
    check_tensor("b_let", b_let, torch.uint8, 2, dev, P)
    la_max, W, _ = _check_inputs("banded_nw_fwd", dev, P, la, lb, dlo, bw,
                                 gp)
    amax, bmax = a_let.shape[1], b_let.shape[1]
    if la_max > amax or int(lb.max()) > bmax:
        raise ValueError("banded_nw_fwd: letter rows shorter than la / lb")
    if dev.type == "cpu":
        return banded_nw_fwd_plain(a_let, b_let, la, lb, dlo, bw, gp, match,
                                   mismatch, W, with_traceback)
    # the kernel writes every byte of tb, rows la .. amax - 1 as zeros
    tb = torch.empty((P, amax, W + 1), dtype=torch.uint8, device=dev) \
        if with_traceback else None
    mlast = torch.empty((P, W), dtype=torch.float32, device=dev)
    dlb = torch.empty(P, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.banded_nw_fwd_launch(
            a_let.data_ptr(), b_let.data_ptr(), amax, bmax, la.data_ptr(),
            lb.data_ptr(), dlo.data_ptr(), bw.data_ptr(), gp.data_ptr(),
            match, mismatch, P, W, None if tb is None else tb.data_ptr(),
            mlast.data_ptr(), dlb.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("banded_nw_fwd", err)
    banded_nw_fwd.launches += 1
    return tb, mlast, dlb


banded_nw_fwd.launches = 0


def banded_nw_fwd_plain(a_let, b_let, la, lb, dlo, bw, gp, match: float,
                        mismatch: float, width: int,
                        with_traceback: bool = True):
    """Plain PyTorch version of banded_nw_fwd: one loop over rows, each
    row's M and D as tensor ops over (pairs, band cells) and its insert
    recurrence as a loop over band cells, batched over pairs; the same
    float32 operations in the same order as the kernel."""
    dev = a_let.device
    f32, i64 = torch.float32, torch.int64
    P, amax = a_let.shape
    bmax = b_let.shape[1]
    W = width
    la_, lb_, dlo_, bw_ = (x.to(i64) for x in (la, lb, dlo, bw))
    (open_a, open_b, ext_a, ext_b, l_open_a, l_open_b, _r_open_a,
     r_open_b, l_ext_a, l_ext_b, _r_ext_a, r_ext_b) = gp[:12]
    match_t = torch.tensor(match, dtype=f32, device=dev)
    mismatch_t = torch.tensor(mismatch, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    kk = torch.arange(W, device=dev, dtype=i64)[None, :]
    rows = torch.arange(P, device=dev)
    neg = torch.full((P,), NEG, dtype=f32, device=dev)
    M = torch.full((P, W + 1), NEG, dtype=f32, device=dev)
    D = torch.full((P, W + 1), NEG, dtype=f32, device=dev)
    M[rows, la_ - dlo_] = 0.0                  # DPM[0][0]
    dlb = neg
    mlast = torch.full((P, W), NEG, dtype=f32, device=dev)
    tb = torch.zeros((P, amax, W + 1), dtype=torch.uint8, device=dev) \
        if with_traceback else None
    a64, b64 = a_let.to(i64), b_let.to(i64)
    for i in range(int(la_.max())):
        active = i < la_
        oa, ea = (l_open_a, l_ext_a) if i == 0 else (open_a, ext_a)
        k_lb = lb_ - dlo_ - i + la_
        m_end = torch.where(k_lb < bw_, M.gather(
            1, k_lb.clamp(0, W)[:, None])[:, 0], neg)
        md_lb = m_end + r_open_b
        de_lb = dlb + r_ext_b
        take_lb = md_lb >= de_lb
        dlb = torch.where(active, torch.where(take_lb, md_lb, de_lb), dlb)
        j = (dlo_ + i - la_)[:, None] + kk
        valid = active[:, None] & (j >= 0) & (j < lb_[:, None]) & \
            (kk < bw_[:, None])
        ca = a64[:, i:i + 1]
        cb = b64.gather(1, j.clamp(0, bmax - 1))
        sub = torch.where((ca < 4) & (cb < 4),
                          torch.where(ca == cb, match_t, mismatch_t), zero)
        ob = torch.where(j == 0, l_open_b, open_b)
        eb = torch.where(j == 0, l_ext_b, ext_b)
        m_diag, d_up = M[:, :W], D[:, 1:]
        # insert state: the sequential recurrence along the row
        mi = m_diag + oa
        i0 = neg
        i_in, iopen = [], []
        for k in range(W):
            i_in.append(i0)
            ie = i0 + ea
            t = mi[:, k] >= ie
            iopen.append(t)
            i0 = torch.where(valid[:, k], torch.where(t, mi[:, k], ie), i0)
        i_in = torch.stack(i_in, 1)
        take_iopen = torch.stack(iopen, 1)
        take_d = d_up > m_diag
        xm = torch.where(take_d, d_up, m_diag)
        take_i = i_in > xm
        xm = torch.where(take_i, i_in, xm)
        md = m_diag + ob
        de = d_up + eb
        take_open = md >= de
        m_new = torch.where(valid, xm + sub, m_diag)
        M = torch.cat([m_new, M[:, W:]], 1)
        D = torch.cat([torch.where(valid, torch.where(take_open, md, de),
                                   D[:, :W]), D[:, W:]], 1)
        if tb is not None:
            bits = (torch.where(take_i, TB_IM, torch.where(take_d, TB_DM, 0))
                    | torch.where(take_open, TB_MD, 0)
                    | torch.where(take_iopen, TB_MI, 0))
            tb[:, i, :W] = torch.where(valid, bits, 0).to(torch.uint8)
            tb[:, i, W] = torch.where(active & take_lb, TB_MD, 0).to(
                torch.uint8)
        last = active & (i == la_ - 1)
        mlast = torch.where(last[:, None], torch.where(valid, m_new, NEG),
                            mlast)
    return tb, mlast.contiguous(), dlb


def banded_nw_chase(tb, mlast, dlb, la, lb, dlo, bw, gp):
    """Final DPI row, final score and state, and the traceback of P >= 1
    pairs from banded_nw_fwd's outputs.

    Returns (scores (P,) float32, states (P,) uint8 OP_M/D/I, tblast
    (P, W) uint8, ops (P, stride) uint8 packed path codes with
    stride = ceil(max(la + lb) / 4)).  With tb None only the first three
    are computed and ops is None."""
    dev = mlast.device
    P, W = mlast.shape
    check_tensor("mlast", mlast, torch.float32, 2, dev)
    check_tensor("dlb", dlb, torch.float32, 1, dev, P)
    la_max, bw_max, steps = _check_inputs("banded_nw_chase", dev, P, la, lb,
                                          dlo, bw, gp)
    if bw_max > W:
        raise ValueError("banded_nw_chase: mlast narrower than the band")
    if tb is not None:
        check_tensor("tb", tb, torch.uint8, 3, dev, P)
        if tb.shape[2] != W + 1 or tb.shape[1] < la_max:
            raise ValueError(f"banded_nw_chase: tb of shape "
                             f"{tuple(tb.shape)} does not fit the pairs")
    stride = (steps + 3) // 4
    if dev.type == "cpu":
        return banded_nw_chase_plain(tb, mlast, dlb, la, lb, dlo, bw, gp,
                                     stride)
    if tb is not None and tb.data_ptr() % 16:
        raise ValueError("banded_nw_chase: tb must start on a 16-byte "
                         "boundary")
    # the kernel writes every byte of ops, OP_PAD past each path
    scores = torch.empty(P, dtype=torch.float32, device=dev)
    states = torch.empty(P, dtype=torch.uint8, device=dev)
    tblast = torch.empty((P, W), dtype=torch.uint8, device=dev)
    ops = torch.empty((P, stride), dtype=torch.uint8, device=dev) \
        if tb is not None else None
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.banded_nw_chase_launch(
            None if tb is None else tb.data_ptr(),
            0 if tb is None else tb.shape[1], mlast.data_ptr(), W,
            dlb.data_ptr(), la.data_ptr(), lb.data_ptr(), dlo.data_ptr(),
            bw.data_ptr(), gp.data_ptr(), P, scores.data_ptr(),
            states.data_ptr(), tblast.data_ptr(),
            None if ops is None else ops.data_ptr(), stride,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("banded_nw_chase", err)
    banded_nw_chase.launches += 1
    return scores, states, tblast, ops


banded_nw_chase.launches = 0


def banded_nw_chase_plain(tb, mlast, dlb, la, lb, dlo, bw, gp, stride: int):
    """Plain PyTorch version of banded_nw_chase: the final-row recurrence
    as one loop over band cells and the chase as one loop over path
    steps, each step batched over pairs."""
    dev = mlast.device
    i64, f32, u8 = torch.int64, torch.float32, torch.uint8
    P, W = mlast.shape
    la_, lb_, dlo_, bw_ = (x.to(i64) for x in (la, lb, dlo, bw))
    r_open_a, r_ext_a = gp[6], gp[10]
    neg = torch.full((P,), NEG, dtype=f32, device=dev)

    # final DPI row: cell k is column dlo - 1 + k, up to lb - 1
    n_last = lb_ - dlo_ + 1
    i1 = neg
    last_bits = []
    for k in range(W):
        v = k < n_last
        mi = (neg if k == 0 else mlast[:, k - 1]) + r_open_a
        ie = i1 + r_ext_a
        t = mi > ie
        i1 = torch.where(v, torch.where(t, mi, ie), i1)
        last_bits.append(torch.where(v & t, TB_MI, 0))
    tblast = torch.stack(last_bits, 1).to(u8)
    scores = mlast.gather(1, (lb_ - dlo_)[:, None])[:, 0]
    st = torch.full((P,), OP_M, dtype=i64, device=dev)
    better_d = dlb > scores
    scores = torch.where(better_d, dlb, scores)
    st = torch.where(better_d, OP_D, st)
    better_i = i1 > scores
    scores = torch.where(better_i, i1, scores)
    st = torch.where(better_i, OP_I, st)
    states = st.to(u8)
    if tb is None:
        return scores.contiguous(), states, tblast, None

    amax = tb.shape[1]
    flat = tb.reshape(-1)
    rows = torch.arange(P, device=dev)
    codes = torch.full((P, 4 * stride + 1), OP_PAD, dtype=u8, device=dev)
    i, j = la_, lb_
    n = torch.zeros(P, dtype=i64, device=dev)
    for _ in range(int((la_ + lb_).max())):
        live = ((i > 0) | (j > 0)) & (i >= 0) & (j >= 0)
        codes.scatter_(1, torch.where(live, n, 4 * stride)[:, None],
                       st.to(u8)[:, None])
        n = n + live.to(i64)
        ri = torch.where(st == OP_I, i, i - 1)
        rj = torch.where(st == OP_D, j, j - 1)
        base = (rows * amax + ri.clamp(0, amax - 1)) * (W + 1)
        k = rj - (dlo_ + ri - la_)
        band = flat[base + k.clamp(0, W)].to(i64)
        band = torch.where(k == -1, TB_IM,
                           torch.where((k >= 0) & (k < bw_), band, 0))
        lbcol = flat[base + W].to(i64)
        kf = rj - dlo_ + 1
        fin = tblast.gather(1, kf.clamp(0, W - 1)[:, None])[:, 0].to(i64)
        fin = torch.where((kf >= 0) & (kf < W), fin, 0)
        bits = torch.where(ri == la_, fin,
                           torch.where(rj == lb_, lbcol, band))
        bits = torch.where((ri >= 0) & (rj >= 0), bits, 0)
        st_m = torch.where((bits & TB_DM) != 0, OP_D,
                           torch.where((bits & TB_IM) != 0, OP_I, OP_M))
        st_d = torch.where((bits & TB_MD) != 0, OP_M, OP_D)
        st_i = torch.where((bits & TB_MI) != 0, OP_M, OP_I)
        st_new = torch.where(st == OP_M, st_m,
                             torch.where(st == OP_D, st_d, st_i))
        st = torch.where(live, st_new, st)
        i = torch.where(live, ri, i)
        j = torch.where(live, rj, j)
    c = codes[:, :4 * stride]
    ops = c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | \
        (c[:, 3::4] << 6)
    return scores.contiguous(), states, tblast, ops.contiguous()


def decode_packed_ops(packed: np.ndarray, n_pairs: int) -> List[str]:
    """(P, stride) uint8 packed codes -> path strings of the first n_pairs
    rows: the codes up to the first OP_PAD, read end to start."""
    P, nb = packed.shape
    ops = np.empty((P, nb * 4), dtype=np.uint8)
    for k in range(4):
        ops[:, k::4] = (packed >> (2 * k)) & 3
    pad = ops == OP_PAD
    n = np.where(pad.any(1), pad.argmax(1), nb * 4)
    asc = _OPS_ASCII[ops]
    return [asc[p, :n[p]][::-1].tobytes().decode("ascii")
            for p in range(n_pairs)]


def _traceback_one(la: int, lb: int, dlo: int, bw: int, state: str,
                   tb: np.ndarray, tblast: np.ndarray) -> str:
    """TraceBackBitMem over one pair's traceback: tb (amax, W + 1) band
    cells and the Drow[LB] bits, tblast (W,) the final DPI row."""
    W = tblast.shape[0]

    def bits(i, j):
        if i == la:
            k = j - dlo + 1
            return int(tblast[k]) if 0 <= k < W else 0
        if j == lb:
            return int(tb[i, W])
        k = j - (dlo + i - la)
        if k == -1:
            return TB_IM  # reference's out-of-band marker TB[i][startj-1]
        return int(tb[i, k]) if 0 <= k < bw else 0

    i, j = la, lb
    out = []
    while not (i == 0 and j == 0):
        out.append(state)
        if state == "M":
            if i <= 0 or j <= 0:
                raise RuntimeError("traceback left the matrix in M")
            t = bits(i - 1, j - 1)
            state = "D" if (t & TB_DM) else ("I" if (t & TB_IM) else "M")
            i -= 1
            j -= 1
        elif state == "D":
            if i <= 0:
                raise RuntimeError("traceback left the matrix in D")
            t = bits(i - 1, j)
            state = "M" if (t & TB_MD) else "D"
            i -= 1
        else:
            if j <= 0:
                raise RuntimeError("traceback left the matrix in I")
            t = bits(i, j - 1)
            state = "M" if (t & TB_MI) else "I"
            j -= 1
    return "".join(reversed(out))


class BandedNWDevice:
    """Batched banded NW for nucleotide pairs on one device, for one set
    of gap penalties: the device oracle."""

    def __init__(self, ap, device):
        self.ap = ap
        self.device = torch.device(device)
        self.gp = gap_params(ap).to(self.device)
        self.match, self.mismatch = match_mismatch(ap)

    def _forward(self, batch: PairBatch, with_traceback: bool):
        args = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device) for x in (batch.a_let, batch.b_let, batch.la,
                                   batch.lb, batch.dlo, batch.bw))
        fwd = banded_nw_fwd(*args, self.gp, self.match, self.mismatch,
                            with_traceback)
        return fwd, args[2:]

    def run_batch(self, batch: PairBatch, with_traceback: bool = True):
        """-> (scores (P,) float32, states (P,) 'M'/'D'/'I', tb, tblast),
        tb (P, amax, W + 1) uint8 (None without traceback) and tblast
        (P, W) uint8 as host arrays, layouts of csrc/banded_nw.cu."""
        (tb, mlast, dlb), geo = self._forward(batch, with_traceback)
        scores, states, tblast, _ = banded_nw_chase(None, mlast, dlb, *geo,
                                                    self.gp)
        return (scores.cpu().numpy(), _STATES[states.cpu().numpy()],
                None if tb is None else tb.cpu().numpy(),
                tblast.cpu().numpy())

    def traceback(self, batch: PairBatch, states, tb, tblast) -> List[str]:
        """Host pointer chase over run_batch's outputs."""
        return [_traceback_one(int(batch.la[p]), int(batch.lb[p]),
                               int(batch.dlo[p]), int(batch.bw[p]),
                               states[p], tb[p], tblast[p])
                for p in range(len(batch.la))]

    def align(self, pairs, band_radius: int, nucleo: bool = True
              ) -> Tuple[np.ndarray, List[str]]:
        batch = pack_pairs(pairs, nucleo, band_radius)
        scores, states, tb, tblast = self.run_batch(batch)
        return scores, self.traceback(batch, states, tb, tblast)

    def align_device(self, pairs, band_radius: int, nucleo: bool = True
                     ) -> Tuple[np.ndarray, List[str]]:
        """Forward DP and traceback on the device; only the packed path
        codes and the scores come back to the host."""
        batch = pack_pairs(pairs, nucleo, band_radius)
        (tb, mlast, dlb), geo = self._forward(batch, True)
        scores, _, _, ops = banded_nw_chase(tb, mlast, dlb, *geo, self.gp)
        return (scores.cpu().numpy(),
                decode_packed_ops(ops.cpu().numpy(), len(pairs)))
