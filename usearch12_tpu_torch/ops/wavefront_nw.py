"""Banded affine-gap global NW on the card: forward kernel and aligner.

Port of usearch12_tpu/ops/wavefront_nw.py.  wavefront_fwd() runs the
forward DP (CUDA kernel csrc/wavefront_fwd.cu on a CUDA tensor, the
plain PyTorch version wavefront_fwd_plain() on a CPU tensor) and writes
traceback nibbles in the layout documented in csrc/wavefront.cuh.
TorchWaveAligner chains it with the traceback of wavefront_trace.py and
keeps the contract of the JAX package's FusedWaveAligner:
align(pairs, band_radius, nucleo) -> (float32 scores, path strings),
bit-exact against align/oracle.py.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..align.oracle import band_diag_range
from ..alpha import CHAR_TO_LETTER_NUCLEO
from ..scoring import AlnParams, nuc_mx
from .wavefront_trace import (NEG, TB_DM, TB_IM, TB_MD, TB_MI,
                              check_geometry, check_tensor, decode_ops,
                              tb_nbytes, wavefront_trace)

MAX_LANES = 1024                        # threads of one block
# widest band the forward kernel takes: (bw + 1) // 2 lanes <= MAX_LANES
BW_MAX = 2 * MAX_LANES - 1
# traceback bytes per launch; TorchWaveAligner splits larger batches
TB_BUDGET = 1 << 30


def letters(seq: np.ndarray) -> np.ndarray:
    """Nucleotide letter classes (A C G T/U = 0..3, anything else 4) of
    an ASCII uint8 array; the JAX package's _letters(seq, True)."""
    return np.minimum(CHAR_TO_LETTER_NUCLEO[seq], 4).astype(np.uint8)


def nucleo_params(open_: float, ext: float, term_open: float,
                  term_ext: float, match: float = 1.0,
                  mismatch: float = -2.0) -> AlnParams:
    """Nucleotide AlnParams with the given gap penalties (AlnParams.init4
    semantics) and match/mismatch scores."""
    ap = AlnParams(nucleo=True, subst_mx=nuc_mx(match, mismatch))
    ap.init4(open_, ext, term_open, term_ext)
    return ap


def gap_params(ap) -> torch.Tensor:
    """(16,) float32 gap penalties of an AlnParams, in the layout of the
    JAX package's WavefrontNWDevice.gp."""
    gp = torch.zeros(16, dtype=torch.float32)
    gp[:12] = torch.tensor(
        [ap.open_a, ap.open_b, ap.ext_a, ap.ext_b,
         ap.l_open_a, ap.l_open_b, ap.r_open_a, ap.r_open_b,
         ap.l_ext_a, ap.l_ext_b, ap.r_ext_a, ap.r_ext_b],
        dtype=torch.float32)
    return gp


def match_mismatch(ap) -> Tuple[float, float]:
    """Scalar nucleotide match and mismatch scores of an AlnParams."""
    mx = ap.subst_mx
    return float(mx[ord("A"), ord("A")]), float(mx[ord("A"), ord("C")])


def wavefront_fwd(a_let, b_let, la, lb, dlo, bw, tb_off, tb_bytes: int,
                  gp, match: float, mismatch: float):
    """Forward DP of P >= 1 pairs.

    a_let (P, amax), b_let (P, bmax) uint8 letter classes; la, lb, dlo,
    bw (P,) int32 lengths and band (dlo <= la - i + j <= dlo + bw - 1);
    tb_off (P,) int64 byte offset of each pair's traceback; gp (16,)
    float32 gap penalties.  Returns (tb (tb_bytes,) uint8 traceback,
    mlast (P, bmax) float32 M values of row la-1 (NEG outside the band),
    dlb (P,) float32 Drow[LB] at (la, lb))."""
    dev = a_let.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"wavefront_fwd: unsupported device {dev}")
    P = a_let.shape[0]
    check_tensor("a_let", a_let, torch.uint8, 2, dev)
    check_tensor("b_let", b_let, torch.uint8, 2, dev, P)
    check_tensor("gp", gp, torch.float32, 1, dev, 16)
    check_tensor("tb_off", tb_off, torch.int64, 1, dev, P)
    for name, x in (("la", la), ("lb", lb), ("dlo", dlo), ("bw", bw)):
        check_tensor(name, x, torch.int32, 1, dev, P)
    amax, bmax = a_let.shape[1], b_let.shape[1]
    bw_max, _, _ = check_geometry(la, lb, bw, tb_off, tb_bytes, bmax, amax)
    if bw_max > BW_MAX:
        raise ValueError(f"wavefront_fwd: band {bw_max} wider than {BW_MAX}")
    if dev.type == "cpu":
        return wavefront_fwd_plain(a_let, b_let, la, lb, dlo, bw, tb_off,
                                   tb_bytes, gp, match, mismatch)
    tb = torch.empty(tb_bytes, dtype=torch.uint8, device=dev)
    mlast = torch.empty((P, bmax), dtype=torch.float32, device=dev)
    dlb = torch.empty(P, dtype=torch.float32, device=dev)
    lanes = ((bw_max + 1) // 2 + 31) // 32 * 32
    # pairs longest first, so that no long pair starts last
    order = torch.argsort(la + lb, descending=True, stable=True).to(
        torch.int32)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.wavefront_fwd_launch(
            a_let.data_ptr(), b_let.data_ptr(), amax, bmax,
            la.data_ptr(), lb.data_ptr(), dlo.data_ptr(), bw.data_ptr(),
            tb_off.data_ptr(), order.data_ptr(), gp.data_ptr(), match,
            mismatch, P, lanes, tb.data_ptr(), mlast.data_ptr(),
            dlb.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wavefront_fwd", err)
    wavefront_fwd.launches += 1
    return tb, mlast, dlb


wavefront_fwd.launches = 0


def wavefront_fwd_plain(a_let, b_let, la, lb, dlo, bw, tb_off,
                        tb_bytes: int, gp, match: float, mismatch: float):
    """Plain PyTorch version of wavefront_fwd: one loop over
    anti-diagonals, each step one set of tensor ops over (pairs, lanes),
    the same float32 operations in the same order as the kernel."""
    dev = a_let.device
    f32, i64 = torch.float32, torch.int64
    P, amax = a_let.shape
    bmax = b_let.shape[1]
    la_, lb_, dlo_, bw_ = (x.to(i64)[:, None] for x in (la, lb, dlo, bw))
    nlane = (bw_ + 1) // 2
    nb = (nlane + 1) // 2
    W = int(nlane.max())
    W += W & 1
    u = torch.arange(W, device=dev, dtype=i64)[None, :]
    k = torch.arange(W // 2, device=dev, dtype=i64)[None, :]
    (open_a, open_b, ext_a, ext_b, l_open_a, l_open_b, _r_open_a,
     r_open_b, l_ext_a, l_ext_b, _r_ext_a, r_ext_b) = gp[:12]
    match_t = torch.tensor(match, dtype=f32, device=dev)
    mismatch_t = torch.tensor(mismatch, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    neg = torch.full((P, W), NEG, dtype=f32, device=dev)
    negcol = neg[:, :1]
    m2 = m1 = dp = ip = neg
    dlb = torch.full((P,), NEG, dtype=f32, device=dev)
    # one spare column / byte takes the writes of lanes that store nothing
    mlast = torch.full((P, bmax + 1), NEG, dtype=f32, device=dev)
    tb = torch.zeros(tb_bytes + 1, dtype=torch.uint8, device=dev)
    a64, b64 = a_let.to(i64), b_let.to(i64)
    steps = la_ + lb_
    for t in range(int(steps.max())):
        rho = (la_ - t - dlo_) & 1
        j = (dlo_ + rho + 2 * u - la_ + t) // 2
        i = t - j
        umax = (bw_ - 1 - rho) // 2
        valid = (u <= umax) & (i >= 0) & (i < la_) & (j >= 0) & (j < lb_)
        m_in = torch.where((i == 0) & (j == 0), zero, m2)
        d_in = torch.where(rho == 1, torch.cat([dp[:, 1:], negcol], 1), dp)
        i_in = torch.where(rho == 1, ip, torch.cat([negcol, ip[:, :-1]], 1))
        ca = a64.gather(1, i.clamp(0, amax - 1))
        cb = b64.gather(1, j.clamp(0, bmax - 1))
        sub = torch.where((ca < 4) & (cb < 4),
                          torch.where(ca == cb, match_t, mismatch_t), zero)
        oa = torch.where(i == 0, l_open_a, open_a)
        ea = torch.where(i == 0, l_ext_a, ext_a)
        ob = torch.where(j == 0, l_open_b, open_b)
        eb = torch.where(j == 0, l_ext_b, ext_b)
        take_d = d_in > m_in
        xm = torch.where(take_d, d_in, m_in)
        take_i = i_in > xm
        xm = torch.where(take_i, i_in, xm)
        md = m_in + ob
        de = d_in + eb
        take_open = md >= de
        mi = m_in + oa
        ie = i_in + ea
        take_iopen = mi >= ie
        m_out = torch.where(valid, xm + sub, neg)
        d_out = torch.where(valid, torch.where(take_open, md, de), neg)
        i_out = torch.where(valid, torch.where(take_iopen, mi, ie), neg)
        bits = (torch.where(take_i, TB_IM, torch.where(take_d, TB_DM, 0))
                | torch.where(take_open, TB_MD, 0)
                | torch.where(take_iopen, TB_MI, 0))
        bits = torch.where(valid, bits, 0)
        mlast.scatter_(1, torch.where(valid & (i == la_ - 1), j, bmax),
                       m_out)
        # Drow[LB] for row i rides the lane whose j == lb
        upd = (j == lb_) & (i >= 0) & (i < la_) & (u < nlane)
        md_lb = m_in + r_open_b
        de_lb = dlb[:, None] + r_ext_b
        take_lb = md_lb >= de_lb
        new_lb = torch.where(take_lb, md_lb, de_lb)
        dlb = torch.where(upd.any(1),
                          torch.where(upd, new_lb, -torch.inf).amax(1), dlb)
        bits = torch.where(upd, torch.where(take_lb, TB_MD, 0), bits)
        byte = bits[:, 0::2] | (bits[:, 1::2] << 4)
        pos = tb_off[:, None] + t * nb + k
        tb.scatter_(0, torch.where((t < steps) & (k < nb), pos,
                                   tb_bytes).flatten(),
                    byte.to(torch.uint8).flatten())
        m2, m1 = m1, m_out
        dp, ip = d_out, i_out
    return tb[:tb_bytes], mlast[:, :bmax].contiguous(), dlb


class WaveLaunch(NamedTuple):
    """Inputs of one wavefront_fwd launch, on one device."""
    a_let: torch.Tensor      # (P, amax) uint8 letter classes
    b_let: torch.Tensor      # (P, bmax) uint8
    la: torch.Tensor         # (P,) int32
    lb: torch.Tensor
    dlo: torch.Tensor
    bw: torch.Tensor
    tb_off: torch.Tensor     # (P,) int64 traceback byte offsets
    tb_bytes: int


def pair_geometry(pairs: Sequence, band_radius: int):
    """(la, lb, dlo, bw) int64 arrays of (a, b) pairs in their
    main-diagonal band (align/oracle.py:band_diag_range)."""
    geo = np.array([(len(a), len(b)) + band_diag_range(
        len(a), len(b), band_radius) for a, b in pairs], np.int64)
    geo = geo.reshape(-1, 4)
    la, lb, dlo = geo[:, 0], geo[:, 1], geo[:, 2]
    bw = geo[:, 3] - dlo + 1
    if len(geo) and (la.min() < 1 or lb.min() < 1):
        raise ValueError("banded NW needs non-empty sequences")
    if len(geo) and bw.max() > BW_MAX:
        raise ValueError(f"band {bw.max()} wider than {BW_MAX}")
    return la, lb, dlo, bw


def pack_letters(pairs: Sequence, la, lb) -> Tuple[np.ndarray, np.ndarray]:
    """(P, max la) and (P, max lb) uint8 letter classes of the pairs' a
    and b, padded with class 4."""
    m = len(pairs)
    amax, bmax = int(la.max()), int(lb.max())
    a_let = np.full((m, amax), 4, np.uint8)
    b_let = np.full((m, bmax), 4, np.uint8)
    a_let[np.arange(amax)[None, :] < la[:, None]] = letters(
        np.concatenate([np.asarray(p[0]) for p in pairs]))
    b_let[np.arange(bmax)[None, :] < lb[:, None]] = letters(
        np.concatenate([np.asarray(p[1]) for p in pairs]))
    return a_let, b_let


def pack_launch(pairs: Sequence, la, lb, dlo, bw,
                device: torch.device) -> WaveLaunch:
    """Letters and geometry of (at least one) pairs as wavefront_fwd's
    inputs."""
    m = len(pairs)
    a_let, b_let = pack_letters(pairs, la, lb)
    nbytes = tb_nbytes(la, lb, bw)
    tb_off = np.zeros(m, np.int64)
    np.cumsum(nbytes[:-1], out=tb_off[1:])

    def to_dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    return WaveLaunch(to_dev(a_let, np.uint8), to_dev(b_let, np.uint8),
                      *(to_dev(x, np.int32) for x in (la, lb, dlo, bw)),
                      to_dev(tb_off, np.int64), int(nbytes.sum()))


class TorchWaveAligner:
    """align(pairs, band_radius, nucleo) -> (scores, paths) on one
    device, for one set of gap penalties (one terminal-gap class).

    pairs are (a, b) ASCII uint8 arrays aligned in their main-diagonal
    band.  Letters are packed on the host; each launch holds at most
    tb_budget bytes of traceback."""

    def __init__(self, ap, device: torch.device, tb_budget: int = TB_BUDGET):
        self.device = device
        self.gp = gap_params(ap).to(device)
        self.match, self.mismatch = match_mismatch(ap)
        self.tb_budget = tb_budget

    def align(self, pairs: Sequence, band_radius: int, nucleo: bool = True
              ) -> Tuple[np.ndarray, List[str]]:
        if not nucleo:
            raise ValueError("TorchWaveAligner scores nucleotides only")
        n = len(pairs)
        scores = np.zeros(n, np.float32)
        paths: List[str] = [""] * n
        la, lb, dlo, bw = pair_geometry(pairs, band_radius)
        nbytes = tb_nbytes(la, lb, bw)
        lo = 0
        while lo < n:
            # greedy split: as many pairs as fit the traceback budget
            hi = lo + max(1, int(np.searchsorted(
                np.cumsum(nbytes[lo:]), self.tb_budget, side="right")))
            sl = slice(lo, hi)
            w = pack_launch(pairs[sl], la[sl], lb[sl], dlo[sl], bw[sl],
                            self.device)
            tb, mlast, dlb = wavefront_fwd(*w, self.gp, self.match,
                                           self.mismatch)
            sc, ops, lens = wavefront_trace(tb, w.tb_off, mlast, dlb, w.la,
                                            w.lb, w.dlo, w.bw, self.gp)
            scores[sl] = sc.cpu().numpy()
            paths[sl] = decode_ops(ops.cpu().numpy(), lens.cpu().numpy())
            lo = hi
        return scores, paths


def native_nw_band(pairs: Sequence, band_radius: int, ap
                   ) -> Tuple[np.ndarray, List[str]]:
    """The host C kernel (native nw_band) on the same pairs and band: a
    judge for the kernels, not a path of the device."""
    import ctypes
    from ..native import GapParams, get_lib
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native host kernels unavailable (no gcc)")
    gp = GapParams.from_alnparams(ap)
    mx = np.ascontiguousarray(ap.subst_mx, dtype=np.float32)
    scores = np.zeros(len(pairs), np.float32)
    paths = []
    for k, (a, b) in enumerate(pairs):
        la, lb = len(a), len(b)
        dlo, dhi = band_diag_range(la, lb, band_radius)
        tb = np.zeros((la + 1) * (lb + 1), dtype=np.uint8)
        mrow = np.zeros(lb + 2, dtype=np.float32)
        drow = np.zeros(lb + 1, dtype=np.float32)
        path = ctypes.create_string_buffer(la + lb + 2)
        score = ctypes.c_float(0)
        n = lib.nw_band(np.ascontiguousarray(a), la, np.ascontiguousarray(b),
                        lb, dlo, dhi, ctypes.byref(gp), mx, tb, mrow, drow,
                        path, ctypes.byref(score))
        if n <= 0:
            raise RuntimeError("nw_band failed")
        scores[k] = score.value
        paths.append(path.raw[:n].decode("ascii"))
    return scores, paths
