"""SINTAX's bootstraps for one chunk of jobs on the card.

Port of the device step of usearch12_tpu/amplicon/sintax_device.py
(BootEngine._build.step).  A job is one strand of one query: its unique
words (slots of the (V, T) word-incidence matrix), their number nuw and
the picks per boot m.  boot_step() runs, for a chunk of cq jobs and B
boots:

1. pick_hist(): the per-boot pick histogram P (cq, B, uwmax), from the
   shared raw LCG stream (boot b's k-th pick of a job is
   stream[b * m + k] % nuw);
2. gather_rows(): each job's incidence rows mq (cq, uwmax, T);
3. U = P @ mq (cq, B, T), a library product that is exact: its operands
   and partial sums are integers of at most m * max|incidence|, so
   float16 operands are exact up to 2048 and float32 (TF32 off) up to
   2^24 (product_dtype());
4. boot_select(): top = max_t U, and the winner, the (rr % m_ties)-th
   target at top in ascending order.

pick_hist() and boot_select() launch the kernels of csrc/sintax_boot.cu
on CUDA tensors, and run their plain PyTorch versions (pick_hist_plain(),
boot_select_plain(), the JAX step written in torch) on CPU tensors.  The
random numbers are the reference's: the stream and the tie-break draws
come from the host as uint32 bits in int32 tensors; the plain versions
take them modulo in int64, so no uint32 wraps differently.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .wavefront_trace import check_tensor

FP16_EXACT = 2048         # every integer up to 2^11 is a float16
FP32_EXACT = 1 << 24
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1}
_U32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of uint32 bits -> int64 tensor of their values."""
    return x.to(torch.int64) & _U32


def product_dtype(device: torch.device, bound: int) -> torch.dtype:
    """The type in which P @ mq is exact when every partial sum is an
    integer of magnitude <= bound: float16 on the card while bound <= 2048
    (the tensor cores' fast path), else float32."""
    if bound > FP32_EXACT:
        raise ValueError(f"boot counts up to {bound} are not exact in "
                         "float32")
    if device.type == "cuda" and bound <= FP16_EXACT:
        return torch.float16
    return torch.float32


def _check_chunk(nuw, m, stream, boots: int, uwmax: int):
    dev = nuw.device
    cq = nuw.shape[0]
    check_tensor("nuw", nuw, torch.int32, 1, dev)
    check_tensor("m", m, torch.int32, 1, dev, cq)
    check_tensor("stream", stream, torch.int32, 1, dev)
    if boots <= 0 or stream.numel() < boots:
        raise ValueError(f"stream of {stream.numel()} draws for {boots} "
                         "boots")
    if cq and (int(nuw.min()) < 0 or int(nuw.max()) > uwmax):
        raise ValueError(f"nuw outside 0..{uwmax}")


def pick_hist(nuw, m, stream, boots: int, uwmax: int,
              dtype: torch.dtype) -> torch.Tensor:
    """Pick histogram P (cq, boots, uwmax) of `dtype` (float32, or
    float16 on the card).  nuw, m (cq,) int32; stream (boots * mmax,)
    int32 holding the raw uint32 LCG draws."""
    _check_chunk(nuw, m, stream, boots, uwmax)
    dev = nuw.device
    if dev.type == "cpu":
        return pick_hist_plain(nuw, m, stream, boots, uwmax, dtype)
    if dev.type != "cuda" or dtype not in _DTYPE_CODE:
        raise ValueError(f"pick_hist: {dtype} on {dev} not supported")
    cq = nuw.shape[0]
    P = torch.empty((cq, boots, uwmax), dtype=dtype, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.sintax_pick_hist_launch(
            nuw.data_ptr(), m.data_ptr(), stream.data_ptr(), stream.numel(),
            boots, cq, uwmax, _DTYPE_CODE[dtype], P.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("sintax_pick_hist", err)
    pick_hist.launches += 1
    return P


pick_hist.launches = 0


def pick_hist_plain(nuw, m, stream, boots: int, uwmax: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """pick_hist() in PyTorch ops (sintax_device.py:125-141)."""
    _check_chunk(nuw, m, stream, boots, uwmax)
    dev = nuw.device
    cq = nuw.shape[0]
    n = stream.numel()
    mmax = n // boots
    m64 = m.to(torch.int64)[:, None, None]
    b = torch.arange(boots, device=dev)[None, :, None]
    k = torch.arange(mmax, device=dev)[None, None, :]
    pos = (b * m64 + k).clamp(0, n - 1)
    draws = _u32(stream)[pos]                              # (cq, B, mmax)
    live = (k < m64).expand(pos.shape)
    pick = draws % nuw.to(torch.int64).clamp(min=1)[:, None, None]
    P = torch.zeros((cq, boots, uwmax), dtype=dtype, device=dev)
    return P.scatter_add_(2, torch.where(live, pick, 0), live.to(dtype))


def gather_rows(w_mat: torch.Tensor, words, nuw,
                dtype: torch.dtype) -> torch.Tensor:
    """Incidence rows of each job's unique words, (cq, uwmax, T) of
    `dtype`, zero past nuw (sintax_device.py:143-146)."""
    check_tensor("words", words, torch.int32, 2, w_mat.device)
    mq = w_mat[words.to(torch.int64).clamp(0, w_mat.shape[0] - 1)]
    live = torch.arange(words.shape[1], device=w_mat.device)[None, :] \
        < nuw[:, None]
    return mq.masked_fill_(~live[:, :, None], 0).to(dtype)


def boot_product(P: torch.Tensor, mq: torch.Tensor) -> torch.Tensor:
    """U = P @ mq, batched over jobs, in P's type, with TF32 off so that
    a float32 product is exact (the JAX step's int8/int32 dot_general)."""
    if P.dtype != mq.dtype:
        raise ValueError("P and mq must share a type")
    if P.device.type != "cuda":
        return torch.bmm(P, mq)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.bmm(P, mq)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def boot_select(U: torch.Tensor, rr) -> Tuple[torch.Tensor, torch.Tensor]:
    """(winner, top) (cq, B) int32 of the boot counts U (cq, B, T) float32
    or float16; rr (cq, B) int32 holding the raw uint32 tie-break draws."""
    dev = U.device
    if U.dtype not in _DTYPE_CODE:
        raise ValueError(f"boot_select: U of {U.dtype}")
    check_tensor("U", U, U.dtype, 3, dev)
    check_tensor("rr", rr, torch.int32, 2, dev, U.shape[0])
    if tuple(rr.shape) != tuple(U.shape[:2]) or U.shape[2] == 0:
        raise ValueError(f"boot_select: U {tuple(U.shape)}, rr "
                         f"{tuple(rr.shape)}")
    if dev.type == "cpu":
        return boot_select_plain(U, rr)
    if dev.type != "cuda":
        raise ValueError(f"boot_select: unsupported device {dev}")
    winner = torch.empty(rr.shape, dtype=torch.int32, device=dev)
    top = torch.empty(rr.shape, dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.sintax_boot_select_launch(
            U.data_ptr(), _DTYPE_CODE[U.dtype], rr.data_ptr(), rr.numel(),
            U.shape[2], winner.data_ptr(), top.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("sintax_boot_select", err)
    boot_select.launches += 1
    return winner, top


boot_select.launches = 0


def boot_select_plain(U: torch.Tensor, rr
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boot_select() in PyTorch ops (sintax_device.py:156-164)."""
    top = U.amax(dim=2)
    is_tie = U == top[:, :, None]
    m_ties = is_tie.sum(dim=2)
    rsel = _u32(rr) % m_ties.clamp(min=1)
    hit = is_tie.cumsum(dim=2) == (rsel + 1)[:, :, None]
    winner = hit.to(torch.uint8).argmax(dim=2)
    return winner.to(torch.int32), top.to(torch.int32)


def boot_step(words, nuw, m, stream, rr, w_mat: torch.Tensor, boots: int,
              inc_absmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(winner, top) (cq, boots) int32 of one chunk (the JAX step's
    outputs).  words (cq, uwmax) int32 incidence rows (padding masked by
    nuw); inc_absmax bounds |w_mat|, so that the product's type is exact."""
    m_max = max(int(m.max()), 0) if m.numel() else 0
    dtype = product_dtype(w_mat.device, m_max * max(inc_absmax, 1))
    P = pick_hist(nuw, m, stream, boots, words.shape[1], dtype)
    U = boot_product(P, gather_rows(w_mat, words, nuw, dtype))
    return boot_select(U, rr)
