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
for tuple.  The chunks run on the engine that the card's boot_engine()
gives (card.py): TorchBootEngine in this process, or a proxy of the
resident server's (device_server.py), which keeps the incidence of a DB
across command runs; only the former imports torch.

SintaxTorchClassifier counts its stages in `stats` (obs.py), which
amplicon/sintax.py:SintaxRun exposes as its dev_stats: the spans
sintax_prepare (unique words, m, the tie-break draws and the chunks' host
arrays), inside it sintax_draws (the draws alone, one call of the C
runtime a window), sintax_boots (the chunks' run_chunk calls: upload,
kernels, copy back) and sintax_tally (host tally and strand vote, one
call of the C runtime a window, in classify_window; SintaxRun's also holds
the rows), a span each a window; the device time sintax_boot_device_ns/_n
(the engine's DeviceTimer around each chunk's kernels in this process:
CUDA events while the profiler records, the host clock on the CPU; none
through the server); the counters sintax_jobs, sintax_chunks, sintax_words
(the jobs' unique words summed), sintax_launches (the engine's kernel
launches in this process; 0 through the server), sintax_draws_native and
sintax_tally_native (the windows whose draws, and whose tally and vote,
the C runtime made; the others took the Python loops, where the library
is not built).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List

import numpy as np

from .. import obs
from ..card import as_card
from .sintax import (SintaxClassifier, _next_rand, ineligible,
                     tally_strand, tally_tuples)

if TYPE_CHECKING:
    from ..device import DeviceLike


class TorchBootEngine:
    """The word-incidence matrix of a DB on `device` and the boot step.

    v word slots, t targets, the CSR postings (sizes (v,), postings
    (nnz,) target indices) and the number of boots.  The matrix is built
    on the device by an accumulating scatter, so a target posted twice
    under one word counts twice (int8).  launches: the boot kernels'
    launches of its chunks."""

    launches = 0

    def __init__(self, v: int, t: int, sizes: np.ndarray,
                 postings: np.ndarray, boots: int,
                 device: DeviceLike) -> None:
        import torch
        self.t = t
        self.B = boots
        self.device = device = torch.device(device)
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

    def run_chunk(self, words, nuw, m, stream, rr, timer=None):
        """(cq, uwmax) words -> (winners, tops) numpy (cq, B) int32.
        stream and rr are uint32 numpy arrays; timer, an obs.DeviceTimer,
        times the boot step between the upload and the copy back."""
        import torch

        from ..ops.sintax_boot import boot_count_select, boot_step, pick_hist

        def up(x):
            return torch.from_numpy(
                np.ascontiguousarray(x).view(np.int32)).to(self.device)

        args = (up(np.asarray(words, np.int32)),
                up(np.asarray(nuw, np.int32)), up(np.asarray(m, np.int32)),
                up(np.asarray(stream, np.uint32)),
                up(np.asarray(rr, np.uint32)))
        n0 = pick_hist.launches + boot_count_select.launches
        if timer is not None:
            timer.start()
        winner, top = boot_step(*args, self.w_mat, self.B, self.inc_absmax)
        if timer is not None:
            timer.stop()
        self.launches += (pick_hist.launches + boot_count_select.launches
                          - n0)
        return winner.cpu().numpy(), top.cpu().numpy()

    def timer(self, on: bool) -> obs.DeviceTimer:
        """A timer of a chunk's boot step on the device (CUDA events only
        where `on`)."""
        return obs.DeviceTimer(self.device, on)


class SintaxTorchClassifier:
    """classify_window with the boots on `card` (card.py), or on a torch
    device of this process (the CPU runs the kernels' plain versions)."""

    def __init__(self, cls: SintaxClassifier, card: DeviceLike,
                 chunk_q: int = 128) -> None:
        self.cls = cls
        self.index = cls.index
        self.chunk_q = chunk_q
        self.index._flatten()
        self.t = self.index.seq_count
        self._stream = None
        self._stream_len = 0
        self.stats = {}
        # set by the caller for each query file: whether the profiler
        # records (obs.profiling()) and the file's number
        self.trace, self.seq = False, None
        index = self.index
        self._engine = as_card(card).boot_engine(
            index, lambda: (index.params.slot_count, self.t,
                            np.asarray(index.sizes),
                            np.asarray(index.postings)), int(cls.boots))

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
        if not seqs:
            return []
        per_q, winners, tops = self.boots(seqs, both)
        with obs.span(self.stats, "sintax_tally", self.trace, self.seq):
            return self.tally(per_q, winners, tops, both)

    def _prepare(self, seqs, both: bool):
        """(per_q, jobs, chunk arrays or None) of a window: per (query,
        strand) the unique words and the picks a boot m, B tie-break draws
        a job in job order, and the chunks' padded host arrays."""
        from ..alpha import revcomp
        cls = self.cls
        params = self.index.params
        B = cls.boots
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
        if not nj:
            return per_q, jobs, None
        m_all = np.array([j[3] for j in jobs], np.int32)
        # the stream length in powers of two, so that chunk shapes
        # repeat from window to window
        mmax = 8
        while mmax < int(m_all.max()):
            mmax *= 2
        stream = self._lcg_stream(B * mmax).astype(np.uint32)
        cq = self.chunk_q
        padded = -(-nj // cq) * cq
        # tie-break draws: B per job, taken in job order, the order of
        # the host's per-strand classify (m == 0 draws too)
        rr_a = np.zeros((padded, B), np.uint32)
        with obs.span(self.stats, "sintax_draws", self.trace, self.seq):
            self._draw(rr_a[:nj])
        uwmax_n = max(int(max(len(j[2]) for j in jobs)), 8)
        uwmax = 1 << int(np.ceil(np.log2(uwmax_n)))
        words = np.zeros((padded, uwmax), np.int32)
        nuw_a = np.ones(padded, np.int32)
        m_a = np.ones(padded, np.int32)
        for k, job in enumerate(jobs):
            uw = job[2]
            words[k, :len(uw)] = uw
            nuw_a[k] = len(uw)
        m_a[:nj] = m_all
        return per_q, jobs, (words, nuw_a, m_a, stream, rr_a)

    def _draw(self, out: np.ndarray) -> None:
        """out (C-contiguous uint32) <- the next out.size draws of the
        classifier's GlobalRand, in order, its state advanced: one call of
        the C runtime (counted in sintax_draws_native) where it is built,
        else a Python call a draw."""
        from ..native import get_lib
        if out.dtype != np.uint32 or not out.flags.c_contiguous:
            raise ValueError("the draws go to a C-contiguous uint32 array")
        grand = self.cls.grand
        lib = get_lib()
        if lib is None:
            flat = out.reshape(-1)
            for k in range(flat.size):
                flat[k] = grand.randu32()
            return
        gx = np.array(grand.x, np.uint64)
        lib.sintax_grand_draws_c(gx.ctypes.data, out.ctypes.data, out.size)
        grand.x[:] = gx.tolist()
        obs.add(self.stats, "sintax_draws_native", 1)

    def boots(self, seqs, both: bool):
        """(per_q, winners, tops) of a window: its jobs' boots, chunk by
        chunk, on the engine."""
        st, tr, seq = self.stats, self.trace, self.seq
        B = self.cls.boots
        with obs.span(st, "sintax_prepare", tr, seq):
            per_q, jobs, arrays = self._prepare(seqs, both)
        nj = len(jobs)
        winners = np.zeros((nj, B), np.int32)
        tops = np.zeros((nj, B), np.int32)
        cq = self.chunk_q
        obs.add(st, "sintax_jobs", nj)
        obs.add(st, "sintax_chunks", -(-nj // cq))
        obs.add(st, "sintax_words", sum(len(j[2]) for j in jobs))
        if arrays is None:
            return per_q, winners, tops
        words, nuw_a, m_a, stream, rr_a = arrays
        eng = self._engine
        with obs.span(st, "sintax_boots", tr, seq):
            n0 = eng.launches
            for lo in range(0, nj, cq):
                hi = min(lo + cq, nj)
                timer = eng.timer(tr)
                w_np, t_np = eng.run_chunk(
                    words[lo:lo + cq], nuw_a[lo:lo + cq], m_a[lo:lo + cq],
                    stream, rr_a[lo:lo + cq], timer)
                winners[lo:hi] = w_np[:hi - lo]
                tops[lo:hi] = t_np[:hi - lo]
                ns = None if timer is None else timer.ns()
                if ns is not None:
                    obs.add(st, "sintax_boot_device_ns", ns)
                    obs.add(st, "sintax_boot_device_n", 1)
            obs.add(st, "sintax_launches", eng.launches - n0)
        return per_q, winners, tops

    def tally(self, per_q, winners, tops, both: bool):
        """Host tally and strand vote (as SintaxClassifier.classify): one
        call of the C runtime a window (counted in sintax_tally_native)
        where it is built, else a Python loop over the queries."""
        from ..native import get_lib
        cls = self.cls
        B = cls.boots
        lib = get_lib()
        if lib is not None:
            n = len(per_q)
            job_map = np.array([[-1 if j is None else j for j in ixs]
                                for ixs in per_q], np.int32).reshape(n, 2)
            winners = np.ascontiguousarray(winners, np.int32)
            tops = np.ascontiguousarray(tops, np.int32)
            ntax = np.empty(n, np.int32)
            ids = np.empty(n * B, np.int32)
            cnts = np.empty(n * B, np.int32)
            twc = np.empty(n, np.int32)
            strand = np.empty(n, np.uint8)
            lib.sintax_tally_window_c(
                winners.ctypes.data, tops.ctypes.data, B,
                job_map.ctypes.data, n, int(both), cls._tax_id.ctypes.data,
                ntax.ctypes.data, ids.ctypes.data, cnts.ctypes.data,
                twc.ctypes.data, strand.ctypes.data)
            obs.add(self.stats, "sintax_tally_native", 1)
            return tally_tuples(B, ntax, ids, cnts, twc, strand)
        res = []
        for fwd_ix, rev_ix in per_q:

            def strand_result(ji):
                if ji is None:
                    return [], [], 0
                twc = int(tops[ji].max()) if B else 0
                return (*tally_strand(cls._tax_id, winners[ji]), twc)

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
