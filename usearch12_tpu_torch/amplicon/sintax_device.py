"""SINTAX's bootstraps on the card.

TorchBootEngine holds the (V, T) int8 word-incidence matrix on the
device and runs one chunk of jobs at a time through
ops/sintax_boot.py:boot_step.  SintaxTorchClassifier builds those chunks
on the host and tallies their winners, with the reference's random
numbers replayed exactly (src/sintaxsearcher.cpp:77-122, 151-187):

1. The per-query boot LCG is re-seeded from -randseed for every query
   (Classify, sintaxsearcher.cpp:146), so the raw 32-bit draw stream is
   the same for every query; only the `% nuw` fold differs.  One
   (boots * mmax,) stream goes to the card per chunk.
2. Boot counting factorizes: U = P @ M_q, P (boots, nuw) the per-boot
   pick histogram, M_q (nuw, T) the incidence rows of the query's unique
   words.
3. The random tie-break takes exactly `boots` draws of the global RNG per
   classified strand, in query order.  The draws do not depend on the
   data, so the host makes them in that order (advancing the shared
   GlobalRand as the host path would) and the card picks the
   (r % ties)-th tie.

classify_window therefore equals SintaxClassifier.classify_window tuple
for tuple.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import DeviceLike
from ..ops.sintax_boot import boot_step
from .sintax import SintaxClassifier, _next_rand, ineligible


class TorchBootEngine:
    """The word-incidence matrix of a DB on `device` and the boot step.

    v word slots, t targets, the CSR postings (sizes (v,), postings
    (nnz,) target indices) and the number of boots.  The matrix is built
    on the device by an accumulating scatter, so a target posted twice
    under one word counts twice (int8)."""

    def __init__(self, v: int, t: int, sizes: np.ndarray,
                 postings: np.ndarray, boots: int,
                 device: torch.device) -> None:
        self.t = t
        self.B = boots
        self.device = device
        nnz = int(sizes.sum())
        # rows of a multiple of 16 bytes, as the card's boot-count kernel
        # copies them; w_mat is the (v, t) view
        width = max(t, 1)
        self.w_mat = torch.zeros((v, -(-width // 16) * 16), dtype=torch.int8,
                                 device=device)[:, :width]
        if t and nnz:
            sizes_d = torch.from_numpy(sizes.astype(np.int64)).to(device)
            words = torch.repeat_interleave(
                torch.arange(v, device=device), sizes_d, output_size=nnz)
            posts = torch.from_numpy(postings.astype(np.int64)).to(device)
            self.w_mat.index_put_(
                (words, posts),
                torch.ones(1, dtype=torch.int8, device=device).expand(nnz),
                accumulate=True)
        self.inc_absmax = max(int(self.w_mat.max()), -int(self.w_mat.min()))

    def run_chunk(self, words, nuw, m, stream, rr):
        """(cq, uwmax) words -> (winners, tops) numpy (cq, B) int32.
        stream and rr are uint32 numpy arrays."""
        def up(x):
            return torch.from_numpy(
                np.ascontiguousarray(x).view(np.int32)).to(self.device)

        winner, top = boot_step(
            up(np.asarray(words, np.int32)), up(np.asarray(nuw, np.int32)),
            up(np.asarray(m, np.int32)), up(np.asarray(stream, np.uint32)),
            up(np.asarray(rr, np.uint32)), self.w_mat, self.B,
            self.inc_absmax)
        return winner.cpu().numpy(), top.cpu().numpy()


class SintaxTorchClassifier:
    """classify_window with the boots on `device` (the CPU runs the
    kernels' plain versions)."""

    def __init__(self, cls: SintaxClassifier, device: DeviceLike,
                 chunk_q: int = 128) -> None:
        self.cls = cls
        self.index = cls.index
        self.chunk_q = chunk_q
        self.index._flatten()
        self.t = self.index.seq_count
        self._stream = None
        self._stream_len = 0
        self._engine = TorchBootEngine(
            self.index.params.slot_count, self.t,
            np.asarray(self.index.sizes), np.asarray(self.index.postings),
            int(cls.boots), torch.device(device))

    @classmethod
    def usable(cls, sc: SintaxClassifier) -> bool:
        return ineligible(sc) is None

    def _lcg_stream(self, n: int) -> np.ndarray:
        """First n draws of the per-query boot LCG (seeded at -randseed;
        the same for every query)."""
        if self._stream is None or self._stream_len < n:
            r = self.cls.randseed
            out = np.empty(n, dtype=np.uint32)
            for k in range(n):
                r = _next_rand(r)
                out[k] = r
            self._stream = out
            self._stream_len = n
        return self._stream[:n]

    def classify_window(self, seqs: List[np.ndarray], both: bool):
        """The contract of SintaxClassifier.classify_window: per query
        (strand, tax ids, counts, last top word count)."""
        from ..alpha import revcomp
        cls = self.cls
        params = self.index.params
        B = cls.boots
        n = len(seqs)
        if n == 0:
            return []

        # per (query, strand): unique words + per-boot sample size m
        jobs = []     # (qi, strand_idx, uw, m)
        per_q = []    # [(fwd_job_ix or None, rev_job_ix or None)]
        for qi, s in enumerate(seqs):
            ixs = []
            for si, qs in enumerate((s, revcomp(s)) if both else (s,)):
                uw = params.unique_words(qs)
                nuw = len(uw)
                if nuw < 8:
                    ixs.append(None)
                    continue
                m = (nuw // cls.boot_subset if cls.boot_subset_divide
                     else cls.boot_subset)
                jobs.append((qi, si, uw, m))
                ixs.append(len(jobs) - 1)
            per_q.append(ixs + [None] * (2 - len(ixs)))

        nj = len(jobs)
        winners = np.zeros((nj, B), np.int32)
        tops = np.zeros((nj, B), np.int32)
        if nj:
            m_all = np.array([j[3] for j in jobs], np.int32)
            # the stream length in powers of two, so that chunk shapes
            # repeat from window to window
            mmax = 8
            while mmax < int(m_all.max()):
                mmax *= 2
            stream = self._lcg_stream(B * mmax).astype(np.uint32)
            # tie-break draws: B per job, taken in job order, the order
            # of the host's per-strand classify (m == 0 draws too)
            rr = np.empty((nj, B), np.uint32)
            for ji in range(nj):
                for b in range(B):
                    rr[ji, b] = cls.grand.randu32()
            uwmax_n = max(int(max(len(j[2]) for j in jobs)), 8)
            uwmax = 1 << int(np.ceil(np.log2(uwmax_n)))
            cq = self.chunk_q
            for lo in range(0, nj, cq):
                hi = min(lo + cq, nj)
                c = hi - lo
                words = np.zeros((cq, uwmax), np.int32)
                nuw_a = np.ones(cq, np.int32)
                m_a = np.ones(cq, np.int32)
                rr_a = np.zeros((cq, B), np.uint32)
                for k in range(c):
                    uw = jobs[lo + k][2]
                    words[k, :len(uw)] = uw
                    nuw_a[k] = len(uw)
                    m_a[k] = jobs[lo + k][3]
                    rr_a[k] = rr[lo + k]
                w_np, t_np = self._engine.run_chunk(words, nuw_a, m_a,
                                                    stream, rr_a)
                winners[lo:hi] = w_np[:c]
                tops[lo:hi] = t_np[:c]

        # host tally and strand vote (as SintaxClassifier.classify)
        from ..search.hitmgr import quick_sort_order
        res = []
        for qi in range(n):
            fwd_ix, rev_ix = per_q[qi][0], per_q[qi][1]

            def strand_result(ji):
                if ji is None:
                    return [], [], 0
                w = winners[ji]
                twc = int(tops[ji].max()) if B else 0
                uti, ucnt = np.unique(cls._tax_id[w], return_counts=True)
                order = quick_sort_order(ucnt.tolist(), desc=True)
                ids = [int(uti[i]) for i in order]
                counts = [int(ucnt[i]) for i in order]
                return ids, counts, twc

            ids_f, cnt_f, twc_f = strand_result(fwd_ix)
            if both:
                ids_r, cnt_r, twc_r = strand_result(rev_ix)
            else:
                ids_r, cnt_r, twc_r = [], [], 0
            if twc_f >= twc_r:
                c_strand, ids, counts = "+", ids_f, cnt_f
            else:
                c_strand, ids, counts = "-", ids_r, cnt_r
            last_twc = twc_r if both else twc_f
            res.append((c_strand, ids, counts, int(last_twc)))
        return res
