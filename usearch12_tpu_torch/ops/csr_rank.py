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

Per chunk of `chunk_b` queries, in torch ops on the device (no kernel of
the port's own: these are the JAX package's jnp stages, not Pallas
kernels): the hit stream, a gather of each query's posting rows through
the segment each position falls in (searchsorted over the rows' running
ends); per-target counts by bincount over row * TP + target; the prefix
maxima by cummax, or the first touches by scatter_reduce(amin); the top K
by topk over one int64 key a target.  The hit stream is capped at
CAP_MAX positions a query; queries above it come back `uncertain` and
make_engine_override (ops/csr_host.py) ranks them on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import obs
from .csr_host import CSRRanker, make_engine_override  # noqa: F401


class CSRDeviceRanker(CSRRanker):
    """Exact USORT ranking of query windows from device-resident CSR
    postings, with the semantics of the host ranker on the same side of
    -big (the host half is ops/csr_host.py's)."""

    def __init__(self, index, device, topk: int = 64,
                 bump: Optional[int] = None, chunk_b: int = 64) -> None:
        super().__init__(index, topk, bump, chunk_b)
        self._put(torch.device(device), *self.csr_arrays())

    @classmethod
    def from_arrays(cls, t: int, starts, sizes, postings, topk: int,
                    bump: int, big: bool, device) -> "CSRDeviceRanker":
        """The device half alone, from csr_arrays()'s arrays of a DB of t
        targets: the resident server's ranker (the JAX package's
        CSRDeviceRanker.from_arrays), whose chunks' words another
        process makes."""
        self = cls.__new__(cls)
        self.index = None
        self.stats = {}
        self._trace = False
        self.t, self.topk, self.bump, self.big = t, topk, bump, big
        self._put(torch.device(device), starts, sizes, postings)
        return self

    def _put(self, device: torch.device, starts, sizes, post) -> None:
        self.device = device
        self._starts = torch.from_numpy(np.asarray(starts, np.int64)).to(
            device)
        self._sizes = torch.from_numpy(np.asarray(sizes, np.int64)).to(
            device)
        self._postings = torch.from_numpy(np.asarray(post, np.int32)).to(
            device)
        # dense count rows of TP >= T + 1 columns
        self.t_bits = max(int(self.t + 1).bit_length(), 7)

    # -- device half -----------------------------------------------------
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

    def run_chunk(self, qw: np.ndarray, cap: int):
        """One chunk on the device -> host (cnts, targets, nextv); its
        upload to its top K timed into stats["rank_device_ns"] (on a CUDA
        device only while the window is traced)."""
        timer = obs.DeviceTimer(self.device, self._trace)
        timer.start()
        q = torch.from_numpy(qw).to(self.device)
        hits = self.hits(q, cap)
        count = self.counts(hits)
        if self.big:
            nc, nt, nextv = self.rank_big(count, hits)
        else:
            nc, nt, nextv = self.rank_sorted(count)
        timer.stop()
        out = torch.stack([nc, nt], 0).cpu().numpy()
        ns = timer.ns()
        if ns is not None:
            obs.add(self.stats, "rank_device_ns", ns)
            obs.add(self.stats, "rank_device_n", 1)
        return out[0], out[1], nextv.cpu().numpy()
