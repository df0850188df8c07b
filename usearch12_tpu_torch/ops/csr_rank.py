"""USORT candidate ranking on a torch device from CSR postings: the ranking
stage of usearch_global's -device_rank.

Port of usearch12_tpu/ops/csr_rank.py (CSRDeviceRanker), which ranks with
the SetTopBump semantics alone.  The reference switches to UDBSearchBig
once a -id search has more than -big targets (search/usorted.py), so this
ranker takes the semantics of the host path it replaces on each side of
-big:

- at or below -big, SetU_NonCoded + SetTopBump + CountSortOrderDesc
  (src/udbusortedsearcher.cpp:375-410, 205-282; src/countsort.h:49): the
  counts in ascending target order, the SetTopBump ratchet as two
  exclusive prefix maxima, NextValue the prefix maximum at the first
  global maximum, the top K by (count desc, target asc);
- above it, UDBSearchBig (src/udbusortedsearcherbig.cpp:31-142, as
  search/usorted.py:_rank_big_py computes it): every big_query_step'th
  unique query word, no SetTopBump, the targets in first-touch order
  (each target's first position in the hit stream), NextValue the
  running maximum before the last record in that order, the top K by
  (count desc, first touch asc).

The device half, CSRChunks, holds the CSR arrays on a device and ranks
a chunk of query words (run_chunk); the host half, ops/csr_host.py's
CSRRanker, cuts the windows into chunks and owns it.  CSRDeviceRanker is
the two on a device of this process.  Two routes rank a chunk, chosen by
what the device half holds:

- UDBSearchBig on a CUDA device: one launch of the kernel of
  csrc/csr_rank.cu (csr_rank_big) for the whole chunk, one block a query
  walking its posting rows and counting in a table of the targets it
  touches, then one copy back of a packed (B, 2K + 2) row a query.
  Nothing of the size of the target set is made, so this route ranks
  each window as one chunk (chunk_b = WINDOW), whatever chunk_b asks.
- Otherwise (SetTopBump, or CPU tensors), in torch ops, the JAX
  package's jnp stages (no Pallas kernel there): the hit stream, a gather
  of each query's posting rows through the segment each position falls
  in (searchsorted over the rows' running ends); per-target counts by
  bincount over row * TP + target; the prefix maxima by cummax, or the
  first touches by scatter_reduce(amin); the top K by topk over one int64
  key a target, in chunks of `chunk_b` (64) queries.  In big mode this
  route (rank_plain) is the kernel's plain version.

The hit stream is capped at CAP_MAX positions a query; queries above it
come back `uncertain` and make_engine_override (ops/csr_host.py) ranks
them on the host.  Besides the host half's, the device half counts in the
ranker's `stats` rank_kernel_launches (the kernel's launches),
rank_touched (the distinct targets counted, summed over the queries; big
mode) and rank_spills (queries whose table the kernel kept in device
memory, not on chip).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _build, obs
from ..card import LocalCard
from .csr_host import CSRRanker, make_engine_override  # noqa: F401
from .wavefront_trace import check_tensor

# most hits of a query whose table the kernel keeps in shared memory (7/8
# of csrc/csr_rank.cu's CR_SLOTS); a query with more has one in device
# memory, twice its hits rounded up to a power of two (at most 2^19 slots
# of 12 bytes: 3 GB for a window of 512 such queries)
SMEM_HITS = 14336


def csr_rank_big(starts, sizes, postings, meta, cap: int, t: int, k: int,
                 spill_total: int) -> torch.Tensor:
    """UDBSearchBig ranking of a chunk on the card (csrc/csr_rank.cu), one
    launch: starts, sizes (V + 2,), (V + 1,) int64 and postings int32, the
    CSR of csr_arrays(); meta (B, wmax + 2) int64, each query's words
    (V: padding), then its table's offset and size in a device-memory
    table of spill_total slots (size 0: on chip).  Returns (B, 2k + 2)
    int32 rows: the top k counts, their targets (0 and t past the touched
    targets), nextv (-1 where a table filled) and the targets touched."""
    dev = meta.device
    if dev.type != "cuda":
        raise ValueError(f"csr_rank_big: {dev} not supported")
    check_tensor("starts", starts, torch.int64, 1, dev)
    check_tensor("sizes", sizes, torch.int64, 1, dev)
    check_tensor("postings", postings, torch.int32, 1, dev)
    check_tensor("meta", meta, torch.int64, 2, dev)
    if not 0 < cap <= CSRRanker.CAP_MAX or k < 1 or meta.shape[1] < 2:
        raise ValueError(f"csr_rank_big: cap {cap}, k {k}, meta "
                         f"{tuple(meta.shape)}")
    B, wmax = meta.shape[0], meta.shape[1] - 2
    out = torch.empty((B, 2 * k + 2), dtype=torch.int32, device=dev)
    cand_key = torch.empty((B, k), dtype=torch.int64, device=dev)
    cand_tgt = torch.empty((B, k), dtype=torch.int32, device=dev)
    spill = torch.empty((3, max(spill_total, 1)), dtype=torch.int32,
                        device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.csr_rank_big_launch(
            starts.data_ptr(), sizes.data_ptr(), postings.data_ptr(),
            meta.data_ptr(), B, wmax, cap, t, k, spill.data_ptr(),
            spill.shape[1], cand_key.data_ptr(), cand_tgt.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("csr_rank_big", err)
    csr_rank_big.launches += 1
    return out


csr_rank_big.launches = 0


class CSRChunks:
    """The ranker's device half: the CSR of a DB of t targets as
    csr_arrays() gives it (starts, sizes, postings) on `device`, and the
    ranking of a chunk of query words with K = topk, -bump and the
    semantics of UDBSearchBig (big) or SetTopBump.  whole_windows: the
    kernel's route, which ranks a window as one chunk."""

    def __init__(self, t: int, starts, sizes, postings, topk: int,
                 bump: int, big: bool, device) -> None:
        self.t, self.topk, self.bump, self.big = t, topk, bump, big
        self.device = device = torch.device(device)
        self._starts = torch.from_numpy(np.asarray(starts, np.int64)).to(
            device)
        self._sizes = torch.from_numpy(np.asarray(sizes, np.int64)).to(
            device)
        self._postings = torch.from_numpy(np.asarray(postings, np.int32)).to(
            device)
        self._sizes_np = np.asarray(sizes, np.int64)
        # dense count rows of TP >= T + 1 columns (the torch ops' route)
        self.t_bits = max(int(self.t + 1).bit_length(), 7)
        # UDBSearchBig on the card takes the kernel; its library is built
        # or loaded here, in set-up
        self.whole_windows = big and device.type == "cuda"
        if self.whole_windows:
            _build.load_library()

    def hits(self, qw: torch.Tensor, cap: int) -> torch.Tensor:
        """(B, cap) hit stream: each query's posting rows end to end, in
        word order, then T."""
        B, wmax = qw.shape
        seg_sizes = self._sizes[qw]
        seg_end = torch.cumsum(seg_sizes, 1)
        pos = torch.arange(cap, device=qw.device).expand(B, cap).contiguous()
        seg = torch.searchsorted(seg_end, pos, right=True).clamp_(max=wmax - 1)
        idx = (self._starts[qw.gather(1, seg)] + pos
               - (seg_end - seg_sizes).gather(1, seg))
        idx = torch.where(pos < seg_end[:, -1:], idx,
                          self._postings.numel() - 1)
        return self._postings[idx].to(torch.int64)

    def counts(self, hits: torch.Tensor) -> torch.Tensor:
        """(B, TP) hits of each target (0 in columns T and above)."""
        B = hits.shape[0]
        TP = 1 << self.t_bits
        rows = torch.arange(B, device=hits.device)[:, None] * TP
        count = torch.bincount((rows + hits).reshape(-1),
                               minlength=B * TP).view(B, TP)
        count[:, self.t:] = 0
        return count

    @staticmethod
    def _excl_prefix_max(x: torch.Tensor) -> torch.Tensor:
        inc = torch.cummax(x, 1).values
        return torch.cat([torch.zeros_like(x[:, :1]), inc[:, :-1]], 1)

    def rank_sorted(self, count: torch.Tensor):
        """SetTopBump ranking of a chunk's counts -> (nc, nt, nextv)."""
        pm = self._excl_prefix_max(count)
        if self.bump != 0:
            nm = (count * self.bump) // 100
            contrib = torch.where((count > pm) & (nm < pm), nm, 0)
            # the JAX ranker's stage_kept: its exclusive prefix maximum
            # of the contributions, shifted one target further
            cm = self._excl_prefix_max(contrib)
            cur_min = torch.cat([torch.zeros_like(cm[:, :1]), cm[:, :-1]],
                                1).clamp_(min=1)
            kept = torch.where(count >= cur_min, count, 0)
        else:
            kept = count
        TP = count.shape[1]
        tgrid = torch.arange(TP, device=count.device)
        maxv = count.max(1).values
        first_max = torch.where(count == maxv[:, None], tgrid, TP - 1).min(1)
        nextv = torch.where(maxv > 0,
                            pm.gather(1, first_max.values[:, None])[:, 0], 0)
        nc, nt = self._top((kept << self.t_bits) | (TP - 1 - tgrid),
                           self.t_bits)
        return nc, nt, nextv

    def rank_big(self, count: torch.Tensor, hits: torch.Tensor):
        """UDBSearchBig ranking of a chunk -> (nc, nt, nextv)."""
        B, TP = count.shape
        cap = hits.shape[1]
        pos = torch.arange(cap, device=hits.device).expand(B, cap)
        first = torch.full((B, TP), cap, dtype=torch.int64,
                           device=hits.device)
        first.scatter_reduce_(1, hits, pos, "amin")
        touched = count > 0
        maxv = count.max(1).values
        first_max = torch.where(touched & (count == maxv[:, None]), first,
                                cap).min(1).values
        nextv = torch.where(touched & (first < first_max[:, None]), count,
                            0).max(1).values
        nc, nt = self._top(torch.where(
            touched, (count << 32) | (0xFFFFFFFF - first), -1), 32)
        return nc, nt, nextv

    def _top(self, key: torch.Tensor, bits: int):
        """The K largest keys of each row, a key a target (unique where
        its count, the bits above `bits`, is not 0) -> (counts, targets),
        count 0 and target T past the row's positive counts."""
        K = self.topk
        k = min(K, key.shape[1])
        topv, topi = torch.topk(key, k, 1)
        if k < K:
            topv = torch.cat([topv, topv.new_full((topv.shape[0], K - k),
                                                  -1)], 1)
            topi = torch.cat([topi, topi.new_zeros((topi.shape[0], K - k))],
                             1)
        nc = torch.where(topv >= 0, topv >> bits, 0)
        return nc, torch.where(nc > 0, topi, self.t)

    def rank_plain(self, q: torch.Tensor, cap: int):
        """A chunk's ranking in torch ops on q's device (in big mode the
        kernel's plain version) -> (nc, nt, nextv) int64 tensors and, in
        big mode, the targets each query touched (else None)."""
        hits = self.hits(q, cap)
        count = self.counts(hits)
        if not self.big:
            return (*self.rank_sorted(count), None)
        return (*self.rank_big(count, hits), (count > 0).sum(1))

    def kernel_meta(self, qw: np.ndarray, cap: int):
        """qw (B, wmax) -> (meta (B, wmax + 2) int64, spill_total,
        spills): csr_rank_big's input, the device-memory table slots its
        rows place, and the number of queries whose table is in device
        memory (those of more than SMEM_HITS hits)."""
        B, wmax = qw.shape
        if qw.size and (qw.min() < 0 or qw.max() >= len(self._sizes_np)):
            raise ValueError("csr_rank_big: a word outside the CSR")
        hits = np.minimum(self._sizes_np[qw].sum(1), cap)
        meta = np.zeros((B, wmax + 2), np.int64)
        meta[:, :wmax] = qw
        spill = hits > SMEM_HITS
        slots = np.array([1 << int(2 * h - 1).bit_length()
                          for h in hits[spill]], np.int64)
        meta[spill, wmax + 1] = slots
        meta[spill, wmax] = np.cumsum(slots) - slots
        return meta, int(slots.sum()), int(spill.sum())

    def run_chunk(self, qw: np.ndarray, cap: int, stats=None,
                  trace: bool = False, seq: Optional[int] = None):
        """One chunk on the device -> host (cnts, targets, nextv), its
        spans and counters in `stats` (None: none kept); its upload to its
        top K timed into stats["rank_device_ns"] (on a CUDA device only
        where `trace`, torch.profiler records the window; seq: the
        request's number)."""
        st = {} if stats is None else stats
        timer = obs.DeviceTimer(self.device, trace)
        if self.whole_windows:
            # the kernel's input is host work of the ranker's own: its
            # time goes to the host half's prepare span
            with obs.span(st, "rank_prepare", trace, seq):
                meta, spill_total, spills = self.kernel_meta(qw, cap)
            timer.start()
            out = csr_rank_big(self._starts, self._sizes, self._postings,
                               torch.from_numpy(meta).to(self.device), cap,
                               self.t, self.topk, spill_total)
            timer.stop()
            out = out.cpu().numpy().astype(np.int64)
            K = self.topk
            nc, nt, nextv, touched = (out[:, :K], out[:, K:2 * K],
                                      out[:, 2 * K], out[:, 2 * K + 1])
            if (nextv < 0).any():
                raise RuntimeError("csr_rank_big: a query's table filled")
            obs.add(st, "rank_kernel_launches", 1)
            obs.add(st, "rank_spills", spills)
        else:
            timer.start()
            nc, nt, nextv, touched = self.rank_plain(
                torch.from_numpy(qw).to(self.device), cap)
            timer.stop()
            out = torch.stack([nc, nt], 0).cpu().numpy()
            nc, nt, nextv = out[0], out[1], nextv.cpu().numpy()
            if touched is not None:
                touched = touched.cpu().numpy()
        ns = timer.ns()
        if ns is not None:
            obs.add(st, "rank_device_ns", ns)
            obs.add(st, "rank_device_n", 1)
        if touched is not None:
            obs.add(st, "rank_touched", int(touched.sum()))
        return nc, nt, nextv


class CSRDeviceRanker(CSRRanker):
    """Exact USORT ranking of query windows from CSR postings on `device`
    in this process, with the semantics of the host ranker on the same
    side of -big: the host half (ops/csr_host.py) and a LocalCard's
    CSRChunks.  chunk_b: the queries a chunk of the torch ops' route,
    whose dense count rows it bounds; the kernel's route ranks each
    window as one chunk."""

    def __init__(self, index, device, topk: int = 64,
                 bump: Optional[int] = None, chunk_b: int = 64) -> None:
        super().__init__(index, LocalCard(device), topk, bump, chunk_b)
