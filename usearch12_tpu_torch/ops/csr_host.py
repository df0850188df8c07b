"""The host half of usearch_global's ranking on the card (-device_rank):
the query words of a window cut into padded chunks (prepare_chunks), the
window loop (rank_window), the cut of the ranked lists (_finish) and the
engine's rank_override (make_engine_override).

This module imports no torch.  A ranker owns its device half, the one
that its card's csr_chunks() returns (card.py): ops/csr_rank.py's
CSRChunks on a torch device in this process, or a proxy of the resident
server's (device_server.py), whose process keeps the CSR arrays on the
card across command runs.  The semantics on each side of -big are
ops/csr_rank.py's.

A ranker counts its stages in `stats` (obs.span): rank_prepare_ns/_n
(prepare_chunks, and the device half's kernel input a chunk),
rank_finish_ns/_n (_finish and the override's host
re-rank), rank_device_ns/_n (a chunk's upload to its top K, where the
device half times it), rank_chunks and rank_hit_slots (chunk rows times the
hit stream's padded length), and what the device half counts (in this
process rank_kernel_launches, rank_touched, rank_spills); the engine's
override adds them into BatchEngine.dev_stats after each window.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import obs
from ..config import options
from ..search.terminator import Terminator
from ..search.usorted import big_query_step


class CSRRanker:
    """Exact USORT ranking of query windows on `card`, a chunk of
    `chunk_b` queries at a time (WINDOW: the window's jobs as one chunk,
    which a device half that ranks whole windows takes whatever chunk_b
    asks), with the semantics of the host ranker on the same side of
    -big."""

    # hit-stream positions a query, at most (the JAX ranker's ceiling)
    CAP_MAX = 1 << 18
    # chunk_b: each window's jobs as one chunk
    WINDOW = 0

    def __init__(self, index, card, topk: int = 64,
                 bump: Optional[int] = None, chunk_b: int = 64) -> None:
        o = options()
        index._flatten()
        self.index = index
        self.topk = topk
        self.bump = int(o.uns("bump")) if bump is None else bump
        self.chunk_b = chunk_b
        self.stats = {}
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
        sizes = np.zeros(v + 1, np.int64)
        sizes[:v] = index.sizes
        self._sizes_np = sizes
        self.dev = card.csr_chunks(index, self.csr_arrays, topk, self.bump,
                                   self.big)
        if self.dev.whole_windows:
            self.chunk_b = self.WINDOW

    def csr_arrays(self):
        """(starts (V + 2,), sizes (V + 1,), postings (nnz + 1,)): the CSR
        with an extra empty row V, the padding word, and postings ending
        with one entry T, where the hit stream's padding positions
        point."""
        v = self._v
        starts = np.zeros(v + 2, np.int64)
        starts[:v + 1] = self.index.starts
        starts[v + 1] = starts[v]
        post = np.concatenate([np.asarray(self.index.postings, np.int32),
                               np.array([self.t], np.int32)])
        return starts, self._sizes_np, post

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
        rows = self.chunk_b or max(n_jobs, 1)
        chunks = []
        for lo in range(0, n_jobs, rows):
            hi = min(lo + rows, n_jobs)
            qw = np.full((rows, wmax), self._v, dtype=np.int64)
            for j, w in enumerate(uw[lo:hi]):
                if not over[lo + j]:
                    qw[j, :len(w)] = w
            chunks.append((lo, hi, qw, cap))
        return n_jobs, chunks, over

    def rank_window(self, jbuf: np.ndarray, j_off: np.ndarray,
                    trace: bool = False, seq: Optional[int] = None):
        """-> (cand (n_jobs, K) int64, cnts uint32, out_n int32, uncertain
        bool), the JAX ranker's contract: each job's first out_n
        candidates are its ranked list (cut at K), cand T where the count
        is 0; uncertain jobs (over CAP_MAX hits) need the host's
        ranking.  trace: torch.profiler records (the stages' ranges, the
        card's timer), seq: the request's number."""
        st = self.stats
        with obs.span(st, "rank_prepare", trace, seq):
            n_jobs, chunks, over = self.prepare_chunks(jbuf, j_off)
        K = self.topk
        cnts = np.zeros((n_jobs, K), dtype=np.int64)
        cand = np.full((n_jobs, K), self.t, dtype=np.int64)
        nextv = np.zeros(n_jobs, dtype=np.int64)
        for lo, hi, qw, cap in chunks:
            c_n, t_n, n_n = self.dev.run_chunk(qw, cap, stats=st,
                                               trace=trace, seq=seq)
            cnts[lo:hi] = c_n[:hi - lo]
            cand[lo:hi] = t_n[:hi - lo]
            nextv[lo:hi] = n_n[:hi - lo]
            obs.add(st, "rank_hit_slots", qw.shape[0] * cap)
        obs.add(st, "rank_chunks", len(chunks))
        with obs.span(st, "rank_finish", trace, seq):
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


def make_engine_override(ranker: CSRRanker, eng):
    """rank_override for BatchEngine.search_window: the window ranked by
    `ranker` (on the card, in this process or the server's); only its
    uncertain jobs are ranked again on the host (counted in
    eng.dev_stats["rank_host_rerank_jobs"]).  The ranker's stats of the
    window are added into eng.dev_stats.  A failure of the device or the
    server raises."""
    def override(jbuf, j_off):
        st = ranker.stats
        before = dict(st)
        cand, cnts, out_n, unc = ranker.rank_window(jbuf, j_off, eng.trace,
                                                    eng.seq)
        redo = np.nonzero(unc)[0]
        if len(redo):
            with obs.span(st, "rank_finish", eng.trace, eng.seq):
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
        for k, v in st.items():
            obs.add(eng.dev_stats, k, v - before.get(k, 0))
        return (np.ascontiguousarray(cand.astype(np.uint32)),
                np.ascontiguousarray(cnts), out_n)
    return override
