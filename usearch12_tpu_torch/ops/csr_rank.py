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
make_engine_override ranks them on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import options
from ..search.terminator import Terminator
from ..search.usorted import big_query_step


class CSRDeviceRanker:
    """Exact USORT ranking of query windows from device-resident CSR
    postings, with the semantics of the host ranker on the same side of
    -big."""

    # hit-stream positions a query, at most (the JAX ranker's ceiling)
    CAP_MAX = 1 << 18

    def __init__(self, index, device, topk: int = 64,
                 bump: Optional[int] = None, chunk_b: int = 64) -> None:
        o = options()
        index._flatten()
        self.index = index
        self.device = torch.device(device)
        self.topk = topk
        self.bump = int(o.uns("bump")) if bump is None else bump
        self.chunk_b = chunk_b
        self.t = index.seq_count
        params = index.params
        self._params = params
        # UDBSearchBig above -big targets, as the host ranker arms it
        # (engine/batch.py:_new_scratch, search/usorted.py:rank)
        self.big = bool(o.filled("id")) and self.t > o.uns("big")
        self._step_args = (o.flt("id"), params.word_length, params.is_nucleo,
                           o.uns("stepwords"), getattr(index, "db_step", 1)
                           ) if self.big else None
        v = params.slot_count
        self._v = v
        # an extra empty row V is the padding word; postings end with one
        # entry T, where the hit stream's padding positions point
        starts = np.zeros(v + 2, np.int64)
        starts[:v + 1] = index.starts
        starts[v + 1] = starts[v]
        sizes = np.zeros(v + 1, np.int64)
        sizes[:v] = index.sizes
        self._sizes_np = sizes
        post = np.concatenate([np.asarray(index.postings, np.int32),
                               np.array([self.t], np.int32)])
        dev = self.device
        self._starts = torch.from_numpy(starts).to(dev)
        self._sizes = torch.from_numpy(sizes).to(dev)
        self._postings = torch.from_numpy(post).to(dev)
        # dense count rows of TP >= T + 1 columns
        self.t_bits = max(int(self.t + 1).bit_length(), 7)

    # -- host half -------------------------------------------------------
    def prepare_chunks(self, jbuf: np.ndarray, j_off: np.ndarray):
        """Letters -> per-chunk padded word arrays (every unique word, or
        the stepped ones in big mode) and one power-of-two geometry for
        the window.  Returns (n_jobs, [(lo, hi, qw, cap)], over)."""
        params = self._params
        n_jobs = len(j_off) - 1
        uw = []
        for j in range(n_jobs):
            w = params.unique_words(jbuf[j_off[j]:j_off[j + 1]])
            if self.big:
                w = w[::big_query_step(len(w), *self._step_args)]
            uw.append(w)
        K = self.topk
        max_w = max([len(w) for w in uw] + [8])
        wmax = 1 << int(np.ceil(np.log2(max_w)))
        totals = np.array([int(self._sizes_np[w].sum()) for w in uw] + [0],
                          np.int64)[:n_jobs]
        over = totals > self.CAP_MAX
        fit = totals[~over] if (~over).any() else np.array([64])
        max_hits = max(int(fit.max(initial=64)), 64, K)
        cap = min(1 << int(np.ceil(np.log2(max_hits))), self.CAP_MAX)
        chunks = []
        for lo in range(0, n_jobs, self.chunk_b):
            hi = min(lo + self.chunk_b, n_jobs)
            qw = np.full((self.chunk_b, wmax), self._v, dtype=np.int64)
            for j, w in enumerate(uw[lo:hi]):
                if not over[lo + j]:
                    qw[j, :len(w)] = w
            chunks.append((lo, hi, qw, cap))
        return n_jobs, chunks, over

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
        """One chunk on the device -> host (cnts, targets, nextv)."""
        q = torch.from_numpy(qw).to(self.device)
        hits = self.hits(q, cap)
        count = self.counts(hits)
        if self.big:
            nc, nt, nextv = self.rank_big(count, hits)
        else:
            nc, nt, nextv = self.rank_sorted(count)
        out = torch.stack([nc, nt], 0).cpu().numpy()
        return out[0], out[1], nextv.cpu().numpy()

    def rank_window(self, jbuf: np.ndarray, j_off: np.ndarray):
        """-> (cand (n_jobs, K) int64, cnts uint32, out_n int32, uncertain
        bool), the JAX ranker's contract: each job's first out_n
        candidates are its ranked list (cut at K), cand T where the count
        is 0; uncertain jobs (over CAP_MAX hits) need the host's
        ranking."""
        n_jobs, chunks, over = self.prepare_chunks(jbuf, j_off)
        K = self.topk
        cnts = np.zeros((n_jobs, K), dtype=np.int64)
        cand = np.full((n_jobs, K), self.t, dtype=np.int64)
        nextv = np.zeros(n_jobs, dtype=np.int64)
        for lo, hi, qw, cap in chunks:
            c_n, t_n, n_n = self.run_chunk(qw, cap)
            cnts[lo:hi] = c_n[:hi - lo]
            cand[lo:hi] = t_n[:hi - lo]
            nextv[lo:hi] = n_n[:hi - lo]
        out = self._finish(cand, cnts, nextv)
        out[3][over] = True
        return out

    def _finish(self, cand, cnts, nextv):
        valid = (cnts > 0) & (cand < self.t)
        first_bad = np.where(valid.all(axis=1), cnts.shape[1],
                             np.argmin(valid, axis=1))
        minv = np.maximum(nextv // 2, 1)
        keep = valid & (cnts >= minv[:, None])
        out_n = np.minimum(first_bad, keep.sum(axis=1)).astype(np.int32)
        term = Terminator("usearch_global")
        bound = term.max_accepts + term.max_rejects
        uncertain = (out_n >= self.topk) & (bound > self.topk)
        return cand, cnts.astype(np.uint32), out_n, uncertain


def make_engine_override(ranker: CSRDeviceRanker, eng):
    """rank_override for BatchEngine.search_window: the window ranked on
    the ranker's device; only its uncertain jobs are ranked again on the
    host (counted in eng.dev_stats["rank_host_rerank_jobs"]).  A failure
    of the device raises."""
    def override(jbuf, j_off):
        cand, cnts, out_n, unc = ranker.rank_window(jbuf, j_off)
        redo = np.nonzero(unc)[0]
        if len(redo):
            parts = [jbuf[j_off[j]:j_off[j + 1]] for j in redo]
            sub_off = np.zeros(len(redo) + 1, np.int64)
            np.cumsum([len(x) for x in parts], out=sub_off[1:])
            h_cand, h_cnts, h_out_n = eng._rank_jobs(
                np.ascontiguousarray(np.concatenate(parts)), sub_off)
            for r, j in enumerate(redo):
                k = min(int(h_out_n[r]), cand.shape[1])
                cand[j, :k] = h_cand[r, :k]
                cnts[j, :k] = h_cnts[r, :k]
                out_n[j] = k
            eng.dev_stats["rank_host_rerank_jobs"] += len(redo)
        return (np.ascontiguousarray(cand.astype(np.uint32)),
                np.ascontiguousarray(cnts), out_n)
    return override
