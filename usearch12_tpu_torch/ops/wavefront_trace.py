"""Traceback of the banded NW DP on the card.

Port of usearch12_tpu/ops/wavefront_trace.py.  wavefront_trace() runs
the final DPI row, the final score and the pointer chase over the
forward kernel's traceback (CUDA kernel csrc/wavefront_trace.cu on a
CUDA tensor, the plain PyTorch version wavefront_trace_plain() on a CPU
tensor).  Paths come back as 2-bit codes (1 = M, 2 = D, 3 = I) from the
end of the alignment to its start, 4 per byte; decode_ops() turns them
into path strings.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build

NEG = float(np.float32(-9e9))          # align/oracle.py MINUS_INFINITY
TB_DM, TB_IM, TB_MD, TB_MI = 1, 2, 4, 8
ST_M, ST_D, ST_I = 0, 1, 2

_OPS_ASCII = np.frombuffer(b"?MDI", dtype=np.uint8)


def decode_ops(ops: np.ndarray, lens: np.ndarray) -> List[str]:
    """(P, stride) uint8 packed codes + (P,) lengths -> path strings."""
    P, stride = ops.shape
    codes = np.empty((P, 4 * stride), np.uint8)
    for k in range(4):
        codes[:, k::4] = (ops >> (2 * k)) & 3
    asc = _OPS_ASCII[codes]
    return [asc[p, :lens[p]][::-1].tobytes().decode("ascii")
            for p in range(P)]


def tb_nbytes(la, lb, bw):
    """Traceback bytes of each pair (csrc/wavefront.cuh layout)."""
    return (la + lb) * (((bw + 1) // 2 + 1) // 2)


def check_tensor(name: str, x, dtype, ndim: int, device, rows=None):
    """Raise ValueError unless x is a contiguous ndim-d dtype tensor on
    device (with `rows` rows when given)."""
    if (x.dtype != dtype or x.dim() != ndim or not x.is_contiguous()
            or x.device != device
            or (rows is not None and x.shape[0] != rows)):
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor on {device}"
                         + ("" if rows is None else f" with {rows} rows")
                         + f", got {x.dtype} {tuple(x.shape)} on {x.device}")


def check_geometry(la, lb, bw, tb_off, tb_bytes: int, bmax: int,
                   amax: Optional[int] = None) -> Tuple[int, int]:
    """Raise ValueError unless every pair is non-empty, has a band of at
    least one diagonal, fits its letter rows and has its traceback inside
    tb_bytes: the kernels index their buffers unchecked.  Returns
    (widest band, longest la + lb, la + lb summed over the pairs)."""
    if la.numel() == 0:
        raise ValueError("no pairs")
    la, lb, bw = la.to(torch.int64), lb.to(torch.int64), bw.to(torch.int64)
    end = tb_off + tb_nbytes(la, lb, bw)
    (la_min, lb_min, bw_min, off_min, la_max, lb_max, bw_max, end_max,
     steps, total) = torch.stack([la.min(), lb.min(), bw.min(), tb_off.min(),
                                  la.max(), lb.max(), bw.max(), end.max(),
                                  (la + lb).max(), (la + lb).sum()]).tolist()
    if min(la_min, lb_min, bw_min) < 1 or off_min < 0 \
            or end_max > tb_bytes or lb_max > bmax \
            or (amax is not None and la_max > amax):
        raise ValueError("pair geometry does not fit the buffers")
    return bw_max, steps, total


def ops_stride(steps: int) -> int:
    """Bytes of one row of packed path codes for paths of up to `steps`
    steps: 4 codes a byte, rounded up to 16 bytes so that the kernel
    stores whole words."""
    return ((steps + 3) // 4 + 15) // 16 * 16


# The warp kernel (one warp per pair) issues every step of every pair;
# the thread kernel (one thread per pair) waits on its longest pair's chain
# of dependent loads.  So the warp kernel is the faster while a launch's
# load, its steps summed over its pairs in units of its longest pair's,
# stays below WARP_MAX_LOAD: trace_crossover.py measured the crossing on
# the H100 at loads of 9,400 to 11,000 for pairs of 250 to 1,000 nt (see
# PERF.md).
WARP_MAX_LOAD = 10000


def takes_warp_kernel(total_steps: int, longest: int) -> bool:
    """Whether the wrapper takes the warp kernel for a launch whose pairs
    have total_steps la + lb steps, the longest `longest`."""
    return total_steps < WARP_MAX_LOAD * longest


def wavefront_trace(tb, tb_off, mlast, dlb, la, lb, dlo, bw, gp,
                    warp: Optional[bool] = None):
    """Scores and paths of P >= 1 pairs from wavefront_fwd's outputs.

    Returns (scores (P,) float32, ops (P, stride) uint8 packed 2-bit
    codes, lens (P,) int32 path lengths), stride = ops_stride(max(la+lb)).
    On the card `warp` picks the kernel (None: takes_warp_kernel()).
    """
    dev = tb.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"wavefront_trace: unsupported device {dev}")
    P = la.shape[0]
    check_tensor("tb", tb, torch.uint8, 1, dev)
    check_tensor("mlast", mlast, torch.float32, 2, dev, P)
    check_tensor("dlb", dlb, torch.float32, 1, dev, P)
    check_tensor("gp", gp, torch.float32, 1, dev, 16)
    check_tensor("tb_off", tb_off, torch.int64, 1, dev, P)
    for name, x in (("la", la), ("lb", lb), ("dlo", dlo), ("bw", bw)):
        check_tensor(name, x, torch.int32, 1, dev, P)
    bw_max, steps, total = check_geometry(la, lb, bw, tb_off, tb.numel(),
                                          mlast.shape[1])
    stride = ops_stride(steps)
    if dev.type == "cpu":
        return wavefront_trace_plain(tb, tb_off, mlast, dlb, la, lb, dlo,
                                     bw, gp, stride)
    if warp is None:
        warp = takes_warp_kernel(total, steps)
    lib = _build.load_library()
    nb_max = ((bw_max + 1) // 2 + 1) // 2
    if warp and (lib.wavefront_trace_smem(nb_max) <= 0
                 or tb.data_ptr() % 16):
        raise ValueError(f"wavefront_trace: band {bw_max} or an unaligned "
                         "traceback does not fit the warp kernel")
    scores = torch.empty(P, dtype=torch.float32, device=dev)
    ops = torch.zeros((P, stride), dtype=torch.uint8, device=dev)
    lens = torch.empty(P, dtype=torch.int32, device=dev)
    # pairs longest first, so that no long pair starts last
    order = torch.argsort(la + lb, descending=True, stable=True).to(
        torch.int32)
    with torch.cuda.device(dev):
        err = lib.wavefront_trace_launch(
            tb.data_ptr(), tb.numel(), tb_off.data_ptr(), order.data_ptr(),
            mlast.data_ptr(), mlast.shape[1], dlb.data_ptr(), la.data_ptr(),
            lb.data_ptr(), dlo.data_ptr(), bw.data_ptr(), gp.data_ptr(), P,
            nb_max, int(warp), scores.data_ptr(), ops.data_ptr(), stride,
            lens.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wavefront_trace", err)
    wavefront_trace.launches += 1
    wavefront_trace.thread_launches += not warp
    return scores, ops, lens


wavefront_trace.launches = 0
# launches that took the thread kernel
wavefront_trace.thread_launches = 0


def wavefront_trace_plain(tb, tb_off, mlast, dlb, la, lb, dlo, bw, gp,
                          stride: int):
    """Plain PyTorch version of wavefront_trace: the final-row recurrence
    as one loop over j and the chase as one loop over path steps, each
    step batched over pairs."""
    dev = tb.device
    i64, f32 = torch.int64, torch.float32
    P = la.shape[0]
    la_, lb_, dlo_, bw_ = (x.to(i64) for x in (la, lb, dlo, bw))
    r_open_a, r_ext_a = gp[6].to(f32), gp[10].to(f32)
    neg = torch.full((P,), NEG, dtype=f32, device=dev)

    # final DPI row over the band of row la-1, in the oracle's order
    startj = torch.minimum((dlo_ - 1).clamp(min=0), lb_ - 1)
    i1 = neg
    jstar = torch.full((P,), -1, dtype=i64, device=dev)
    for j in range(int(lb_.max())):
        active = (j >= startj) & (j < lb_)
        mprev = mlast[:, j - 1] if j > 0 else neg
        mi = torch.where(startj == j, neg, mprev) + r_open_a
        i1e = i1 + r_ext_a
        take = mi > i1e
        i1 = torch.where(active, torch.where(take, mi, i1e), i1)
        jstar = torch.where(active & take, j, jstar)
    rows = torch.arange(P, device=dev)
    scores = mlast[rows, lb_ - 1]
    st = torch.full((P,), ST_M, dtype=i64, device=dev)
    better_d = dlb > scores
    scores = torch.where(better_d, dlb, scores)
    st = torch.where(better_d, ST_D, st)
    better_i = i1 > scores
    scores = torch.where(better_i, i1, scores)
    st = torch.where(better_i, ST_I, st)

    nlane = (bw_ + 1) // 2
    nb = (nlane + 1) // 2
    last = max(tb.numel() - 1, 0)
    codes = torch.zeros((P, 4 * stride + 1), dtype=torch.uint8, device=dev)
    i, j = la_, lb_
    n = torch.zeros(P, dtype=i64, device=dev)
    for _ in range(int((la_ + lb_).max())):
        live = ((i > 0) | (j > 0)) & (i >= 0) & (j >= 0)
        codes.scatter_(1, torch.where(live, n, 4 * stride)[:, None],
                       (st + 1).to(torch.uint8)[:, None])
        n = n + live.to(i64)
        ri = torch.where(st == ST_I, i, i - 1)
        rj = torch.where(st == ST_D, j, j - 1)
        k = la_ - ri + rj - dlo_
        pos = (tb_off + (ri + rj) * nb + (k >> 2)).clamp(0, last)
        nib = (tb[pos].to(i64) >> (((k >> 1) & 1) * 4)) & 15
        lbcol = torch.where((k >> 1) < nlane, nib, TB_MD)
        band = torch.where(k == -1, TB_IM,
                           torch.where((k >= 0) & (k < bw_), nib, 0))
        bits = torch.where(ri == la_, torch.where(rj == jstar, TB_MI, 0),
                           torch.where(rj == lb_, lbcol, band))
        bits = torch.where((ri >= 0) & (rj >= 0), bits, 0)
        st_m = torch.where((bits & TB_DM) != 0, ST_D,
                           torch.where((bits & TB_IM) != 0, ST_I, ST_M))
        st_d = torch.where((bits & TB_MD) != 0, ST_M, ST_D)
        st_i = torch.where((bits & TB_MI) != 0, ST_M, ST_I)
        st_new = torch.where(st == ST_M, st_m,
                             torch.where(st == ST_D, st_d, st_i))
        st = torch.where(live, st_new, st)
        i = torch.where(live, ri, i)
        j = torch.where(live, rj, j)
    c = codes[:, :4 * stride]
    ops = c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | \
        (c[:, 3::4] << 6)
    return scores.contiguous(), ops.contiguous(), n.to(torch.int32)
