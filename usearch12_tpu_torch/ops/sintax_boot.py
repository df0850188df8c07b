"""SINTAX's bootstraps for one chunk of jobs on the card.

Port of the device step of usearch12_tpu/amplicon/sintax_device.py
(BootEngine._build.step).  A job is one strand of one query: its unique
words (slots of the (V, T) word-incidence matrix), their number nuw and
the picks per boot m.  boot_step() runs, for a chunk of cq jobs and B
boots:

1. pick_hist(): the per-boot pick histogram P (cq, B, uwmax), from the
   shared raw LCG stream (boot b's k-th pick of a job is
   stream[b * m + k] % nuw);
2. boot_count_select(): the boot counts U = P @ mq (cq, B, T), mq the
   incidence rows of each job's words, top = max_t U, and the winner, the
   (rr % m_ties)-th target at top in ascending order.

Both launch the kernels of csrc/sintax_boot.cu on CUDA tensors, and run
their plain PyTorch versions on CPU tensors.  On the card
boot_count_select() never writes mq or U: it counts tiles of U on the
tensor cores and keeps each tile's (max, count at max), then picks.  Its
plain version, boot_count_select_plain(), runs the same two stages over
the plain route: gather_rows() (mq), boot_product() (a bmm into U) and a
merge of U's tiles; boot_select_plain() is the JAX step's select written
in torch.  Every product is exact: its operands and partial sums are
integers of at most m * max|incidence| (product_dtype()), and on the card
a count above 2048, which float16 does not hold, is split over repeated
word slots (split_slots()).  The random
numbers are the reference's: the stream and the tie-break draws come from
the host as uint32 bits in int32 tensors; the plain versions take them
modulo in int64, so no uint32 wraps differently.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .wavefront_trace import check_tensor

INT8_MAX = 127            # the JAX step's int8_ok rule: m <= 127
FP16_EXACT = 2048         # every integer up to 2^11 is a float16
FP32_EXACT = 1 << 24
TILE = 256                # targets a tile of U (csrc/sintax_boot.cu BC_NT)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.int8: 2}
_U32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of uint32 bits -> int64 tensor of their values."""
    return x.to(torch.int64) & _U32


def product_dtype(device: torch.device, m_max: int,
                  inc_absmax: int) -> torch.dtype:
    """The type of the operand P for picks of up to m_max per boot against
    an incidence of magnitude up to inc_absmax, in which U = P @ mq is
    exact.  On the card: int8 while m_max <= 127 (int32 sums), else
    float16 (float32 sums; above 2048 picks boot_step() splits the counts,
    split_slots()); on the CPU float32.  Raises where a sum may pass
    2^24."""
    bound = m_max * max(inc_absmax, 1)
    if bound > FP32_EXACT:
        raise ValueError(f"boot counts up to {bound} are not exact in "
                         "float32")
    if device.type != "cuda":
        return torch.float32
    return torch.int8 if m_max <= INT8_MAX else torch.float16


_COUNT_MAX = {torch.int8: INT8_MAX, torch.float16: FP16_EXACT,
              torch.float32: FP32_EXACT}


def _check_chunk(nuw, m, stream, boots: int, uwmax: int,
                 dtype: torch.dtype):
    """Raise unless the chunk fits the kernel: 0 <= nuw <= uwmax, m >= 0
    and every count (at most m) exact in `dtype`.  One wait for the
    device."""
    dev = nuw.device
    cq = nuw.shape[0]
    check_tensor("nuw", nuw, torch.int32, 1, dev)
    check_tensor("m", m, torch.int32, 1, dev, cq)
    check_tensor("stream", stream, torch.int32, 1, dev)
    if boots <= 0 or stream.numel() < boots:
        raise ValueError(f"stream of {stream.numel()} draws for {boots} "
                         "boots")
    if dtype not in _COUNT_MAX:
        raise ValueError(f"counts of {dtype} not supported")
    if not cq:
        return
    nuw_min, nuw_max, m_min, m_max = torch.stack([
        nuw.min(), nuw.max(), m.min(), m.max()]).tolist()
    if nuw_min < 0 or nuw_max > uwmax:
        raise ValueError(f"nuw outside 0..{uwmax}")
    if m_min < 0 or m_max > _COUNT_MAX[dtype]:
        raise ValueError(f"m outside 0..{_COUNT_MAX[dtype]} for {dtype}")


def pick_hist(nuw, m, stream, boots: int, uwmax: int,
              dtype: torch.dtype) -> torch.Tensor:
    """Pick histogram P (cq, boots, uwmax) of `dtype` (product_dtype():
    float32, or int8 or float16 on the card).  nuw, m (cq,) int32; stream
    (boots * mmax,) int32 holding the raw uint32 LCG draws.  On the card
    the kernel counts tiles of P in shared memory (csrc/sintax_boot.cu)."""
    _check_chunk(nuw, m, stream, boots, uwmax, dtype)
    dev = nuw.device
    if dev.type == "cpu":
        return pick_hist_plain(nuw, m, stream, boots, uwmax, dtype)
    if dev.type != "cuda":
        raise ValueError(f"pick_hist: {dev} not supported")
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
    _check_chunk(nuw, m, stream, boots, uwmax, dtype)
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


def boot_select_plain(U: torch.Tensor, rr
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(winner, top) (cq, B) int32 of the boot counts U (cq, B, T): the
    JAX step's select (sintax_device.py:156-164) in PyTorch ops; rr as
    boot_count_select() takes it."""
    top = U.amax(dim=2)
    is_tie = U == top[:, :, None]
    m_ties = is_tie.sum(dim=2)
    rsel = _u32(rr) % m_ties.clamp(min=1)
    hit = is_tie.cumsum(dim=2) == (rsel + 1)[:, :, None]
    winner = hit.to(torch.uint8).argmax(dim=2)
    return winner.to(torch.int32), top.to(torch.int32)


def _check_counts(P, words, nuw, w_mat, rr):
    dev = P.device
    check_tensor("words", words, torch.int32, 2, dev)
    cq, uwmax = words.shape
    check_tensor("P", P, P.dtype, 3, dev, cq)
    check_tensor("nuw", nuw, torch.int32, 1, dev, cq)
    check_tensor("rr", rr, torch.int32, 2, dev, cq)
    if (P.shape[2] != uwmax or tuple(rr.shape) != tuple(P.shape[:2])
            or w_mat.dtype != torch.int8 or w_mat.dim() != 2
            or w_mat.device != dev or w_mat.stride(1) != 1
            or min(w_mat.shape) < 1):
        raise ValueError(f"boot counts: P {tuple(P.shape)}, words "
                         f"{tuple(words.shape)}, rr {tuple(rr.shape)}, "
                         f"w_mat {w_mat.dtype} {tuple(w_mat.shape)}")
    if cq and (int(nuw.min()) < 0 or int(nuw.max()) > uwmax):
        raise ValueError(f"nuw outside 0..{uwmax}")


def boot_count_select(P, words, nuw, w_mat: torch.Tensor, rr
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(winner, top) (cq, B) int32 of the boot counts U = P @ mq, mq the
    incidence rows w_mat[words] (ids clipped to w_mat, zero at slots >=
    nuw).  P (cq, B, uwmax) from pick_hist (int8 or float16 on the card);
    words (cq, uwmax), nuw (cq,) int32; w_mat (V, T) int8 with unit
    column stride (on the card rows of a multiple of 16 bytes, 16-byte
    aligned); rr (cq, B) int32 holding the raw uint32 tie-break draws."""
    _check_counts(P, words, nuw, w_mat, rr)
    dev = P.device
    if dev.type == "cpu":
        return boot_count_select_plain(P, words, nuw, w_mat, rr)
    if (dev.type != "cuda" or P.dtype not in (torch.int8, torch.float16)
            or words.shape[1] % 8 or w_mat.stride(0) % 16
            or w_mat.data_ptr() % 16):
        raise ValueError(f"boot_count_select: P of {P.dtype} with "
                         f"{words.shape[1]} slots, w_mat strides "
                         f"{w_mat.stride()} on {dev} not supported")
    cq, boots, uwmax = P.shape
    V, T = w_mat.shape
    lib = _build.load_library()
    part = torch.empty(lib.sintax_boot_partial_bytes(cq, boots, T) // 4,
                       dtype=torch.int32, device=dev)
    winner = torch.full((cq, boots), -1, dtype=torch.int32, device=dev)
    top = torch.empty((cq, boots), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.sintax_boot_count_select_launch(
            P.data_ptr(), _DTYPE_CODE[P.dtype], cq, boots, uwmax,
            words.data_ptr(), nuw.data_ptr(), w_mat.data_ptr(),
            w_mat.stride(0), V, T, rr.data_ptr(), part.data_ptr(),
            winner.data_ptr(), top.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("sintax_boot_count_select", err)
    boot_count_select.launches += 1
    return winner, top


boot_count_select.launches = 0


def boot_count_select_plain(P, words, nuw, w_mat: torch.Tensor, rr,
                            tile: int = TILE,
                            dtype: torch.dtype = torch.float32
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boot_count_select() in PyTorch ops, stage for stage: U by the plain
    route in `dtype` (exact where product_dtype() says so), each boot
    row's (max, count at max) over tiles of `tile` targets, the merge into
    (top, m_ties), the tile that holds the (rr % m_ties)-th tie in
    ascending order, and that tile of that row recomputed from P and
    w_mat to find the tie."""
    _check_counts(P, words, nuw, w_mat, rr)
    dev = P.device
    cq, boots, uwmax = P.shape
    T = w_mat.shape[1]
    U = boot_product(P.to(dtype), gather_rows(w_mat, words, nuw, dtype))
    nt = -(-T // tile)
    Ut = torch.cat([U.float(), U.new_full((cq, boots, nt * tile - T),
                                          -torch.inf, dtype=torch.float32)],
                   2).view(cq, boots, nt, tile)
    del U
    tmax = Ut.amax(3)                                    # partials
    tcnt = (Ut == tmax[..., None]).sum(3)
    del Ut
    top = tmax.amax(2)
    cnt = torch.where(tmax == top[..., None], tcnt, 0)
    rsel = _u32(rr) % cnt.sum(2).clamp(min=1)
    cum = cnt.cumsum(2)
    hit = (cum > rsel[..., None]).to(torch.uint8).argmax(2, keepdim=True)
    r2 = rsel - (cum.gather(2, hit) - cnt.gather(2, hit))[..., 0]
    # U of the hit tile of each row, from the slots where P is non-zero
    cols = hit * tile + torch.arange(tile, device=dev)   # (cq, B, tile)
    live = torch.arange(uwmax, device=dev)[None, :] < nuw[:, None]
    wid = words.to(torch.int64).clamp(0, w_mat.shape[0] - 1)
    row_u = torch.zeros((cq, boots, tile), dtype=torch.int64, device=dev)
    for k in range(uwmax):
        pk = torch.where(live[:, k, None], P[:, :, k].to(torch.int64), 0)
        inc = w_mat[wid[:, k, None, None], cols.clamp(max=T - 1)]
        row_u += pk[..., None] * inc.to(torch.int64)
    ties = (row_u == top[..., None].to(torch.int64)) & (cols < T)
    pos = (ties.cumsum(2) == (r2 + 1)[..., None]).to(torch.uint8).argmax(2)
    return (hit[..., 0] * tile + pos).to(torch.int32), top.to(torch.int32)


def split_slots(P, words, nuw):
    """Float32 counts P (cq, B, uwmax) as float16 operands: every slot
    repeated k times, k = ceil(max(P) / 2048), and its count split into
    parts of at most 2048, the first ones full.  Returns (P', words',
    nuw') (slot s of a job becomes slots s*k .. s*k + k - 1), with
    P' @ mq' = P @ mq and every count of P' exact in float16."""
    cq, boots, uwmax = P.shape
    k = max(1, -(-int(P.max()) // FP16_EXACT)) if P.numel() else 1
    part = FP16_EXACT * torch.arange(k, dtype=P.dtype, device=P.device)
    P = (P[..., None] - part).clamp_(0, FP16_EXACT)
    return (P.reshape(cq, boots, uwmax * k).to(torch.float16),
            words.repeat_interleave(k, dim=1).contiguous(),
            (nuw * k).contiguous())


def boot_step(words, nuw, m, stream, rr, w_mat: torch.Tensor, boots: int,
              inc_absmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(winner, top) (cq, boots) int32 of one chunk (the JAX step's
    outputs).  words (cq, uwmax) int32 incidence rows (padding masked by
    nuw); inc_absmax bounds |w_mat|, so that the product's type is exact."""
    m_max = max(int(m.max()), 0) if m.numel() else 0
    dtype = product_dtype(w_mat.device, m_max, inc_absmax)
    if dtype == torch.float16 and m_max > FP16_EXACT:
        # a slot may be picked more than 2048 times in a boot, which
        # float16 does not hold: count in float32, then split
        P, words, nuw = split_slots(
            pick_hist(nuw, m, stream, boots, words.shape[1], torch.float32),
            words, nuw)
    else:
        P = pick_hist(nuw, m, stream, boots, words.shape[1], dtype)
    return boot_count_select(P, words, nuw, w_mat, rr)
