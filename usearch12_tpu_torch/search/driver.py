"""Search pipeline driver: SeqSource -> rank -> align -> accept/terminate ->
sinks.  Equivalent of Search()/Thread()/Searcher::Search
(src/search.cpp:51-141, src/searcher.cpp:122-161) with the alignment work
organized so it can be dispatched to batched device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from ..config import options
from ..io.seqdb import SeqDB
from ..io.fastx import read_fastx, file_is_nucleo
from ..scoring import AlnParams, AlnHeuristics
from ..index.udb import UDBIndex, UDBParams
from ..align.hsp import HSPFinder
from ..align.global_aligner import global_align
from ..align.result import AlignResult
from .accepter import Accepter
from .terminator import Terminator
from .hitmgr import HitMgr
from .usorted import USortedRanker

# options that force the Python accept/terminate loop (anything beyond
# -id/-maxid, counter-based termination)
_FAST_LOOP_BLOCKERS = (
    "evalue", "query_cov", "max_query_cov", "target_cov",
    "max_target_cov", "abskew", "min_sizeratio", "minqt", "maxqt",
    "minsl", "maxsl", "termid", "termidd", "mincols", "maxgaps",
    "maxdiffs", "mindiffs")


def requested_thread_count() -> int:
    """GetRequestedThreadCount (src/myutils.cpp:151-175): -threads if
    given, else min(cores, 10)."""
    o = options()
    if o.filled("threads"):
        return max(1, o.uns("threads"))
    import os
    return min(os.cpu_count() or 1, 10)


def fast_loop_eligible(accepter) -> bool:
    """True when accept/reject/terminate semantics reduce to the C
    fast-path loop (search_ranked_c)."""
    if accepter.accept_all:
        return False
    o = options()
    for opt in _FAST_LOOP_BLOCKERS:
        if o.filled(opt):
            return False
    if o.flag("self") or o.flag("notself") or o.flag("selfid"):
        return False
    # the C rank scratch counts word hits in uint16 (a target's count is
    # bounded by its length); an enlarged -maxseqlength could overflow it
    if o.uns("maxseqlength") > 65535:
        return False
    return True


def fast_search_hits(native, q_seq, tix_order, max_accepts: int,
                     max_rejects: int, full_dp_always: bool):
    """Run the C fast-path loop for one strand; returns [(tix, path)].
    The native aligner's DB view must be current."""
    o = options()
    native.set_a(q_seq)
    min_id = o.flt("id") if o.filled("id") else -1.0
    has_max_id = o.filled("maxid")
    max_id = o.flt("maxid") if has_max_id else 1.0
    return native.search_ranked(
        tix_order, min_id, max_id, has_max_id, max_accepts, max_rejects,
        full_dp_always, not o.flag("gaforce"))


@dataclass
class SearchContext:
    """Everything MakeDBSearcher wires together (src/makedbsearcher.cpp)."""
    cmd: str
    db: SeqDB
    index: UDBIndex
    ap: AlnParams
    ah: AlnHeuristics
    accepter: Accepter
    terminator: Terminator
    hitmgr: HitMgr
    ranker: USortedRanker
    hf: HSPFinder
    nucleo: bool
    hole_kernel: Optional[Callable] = None
    native: Optional[object] = None
    local: bool = False
    local_aligner: Optional[object] = None

    @classmethod
    def build(cls, cmd: str, db: SeqDB, hole_kernel=None,
              index: Optional[UDBIndex] = None) -> "SearchContext":
        nucleo = db.get_is_nucleo()
        ap = AlnParams.from_cmdline(nucleo)
        ah = AlnHeuristics.from_cmdline(ap)
        if index is None:
            index = UDBIndex.from_seqdb(db)
        local = cmd == "usearch_local"
        local_aligner = None
        if local:
            from .local import EStats, LocalAligner2
            es = EStats.from_cmdline(nucleo, db)
            local_aligner = LocalAligner2(ap, ah, es)
        native = None
        if not local and hole_kernel is None and \
                not options().flag("use_cpu_oracle"):
            try:
                from ..native import NativeAligner
                native = NativeAligner(ap, ah)
            except Exception:
                native = None
        return cls(cmd=cmd, db=db, index=index, ap=ap, ah=ah,
                   accepter=Accepter(is_global=not local),
                   terminator=Terminator(cmd),
                   hitmgr=HitMgr(),
                   ranker=USortedRanker(index),
                   hf=HSPFinder(ap, ah),
                   nucleo=nucleo,
                   hole_kernel=hole_kernel,
                   native=native,
                   local=local,
                   local_aligner=local_aligner)

    # -- one query through the search loop --------------------------------
    def search_query(self, q_label: str, q_seq: np.ndarray,
                     revcomp: bool = False) -> List[AlignResult]:
        """SearchImpl (src/udbusortedsearcher.cpp:122-152) for one strand.
        Returns accepted hits (order of acceptance)."""
        hm = self.hitmgr
        hm.set_query(q_label)
        self.terminator.on_new_query()
        self._search_strand(q_label, q_seq, revcomp=False)
        if revcomp:
            from ..alpha import revcomp as rc
            self.terminator.on_new_query()
            self._search_strand(q_label, rc(q_seq), revcomp=True)
        return hm.hits

    def search_query_xlat(self, q_label: str, q_seq: np.ndarray
                          ) -> List[AlignResult]:
        """SearchXlat (src/searcher.cpp:95-120): translated search — each
        6-frame ORF searched as an amino query, hits accumulate per
        nucleotide query."""
        from .orf import orf_iter
        hm = self.hitmgr
        hm.set_query(q_label)
        nuc_l = len(q_seq)
        for aa, frame, lo, hi in orf_iter(q_seq):
            self.terminator.on_new_query()
            self._search_strand(q_label, aa, revcomp=False,
                                orf=(frame, lo, hi, nuc_l, q_seq))
        return hm.hits

    def _fast_loop_ok(self) -> bool:
        """True when the accept/terminate logic reduces to the C fast
        path: -id (+ default maxid) only, counter-based termination."""
        cached = getattr(self, "_fast_ok", None)
        if cached is not None:
            return cached
        ok = self.native is not None and \
            fast_loop_eligible(self.accepter)
        if ok:
            self.native.set_db_view(self.db.seqs)
        self._fast_ok = ok
        return ok

    def _search_strand_fast(self, q_label: str, q_seq: np.ndarray,
                            revcomp: bool, tix_order, orf) -> None:
        """C fast path: align+accept+terminate in one native call, then
        materialize the accepted AlignResults."""
        if self.native._db_n != len(self.db.seqs):
            self.native.set_db_view(self.db.seqs)   # DB grew: rebuild view
        hits = fast_search_hits(self.native, q_seq, tix_order,
                                self.terminator.max_accepts,
                                self.terminator.max_rejects,
                                self.ah.full_dp_always)
        db = self.db
        for tix, path in hits:
            ar = AlignResult(query_label=q_label, target_label=db.labels[tix],
                             query_seq=q_seq, target_seq=db.seqs[tix],
                             path=path, nucleo=self.nucleo,
                             target_index=tix, query_revcomp=revcomp)
            if orf is not None:
                (ar.orf_frame, ar.orf_nuc_lo, ar.orf_nuc_hi,
                 ar.orf_nuc_l, ar.orf_nuc_seq) = orf
            self.hitmgr.append_hit(ar)

    def _search_strand(self, q_label: str, q_seq: np.ndarray,
                       revcomp: bool, orf=None) -> None:
        if self.local and orf is None and self._local_fast_ok():
            nr = getattr(self.ranker, "_native", None)
            if nr is not None and not options().flag("quicksort"):
                tix_raw = nr.rank_raw(q_seq, options().uns("bump"), 0)
                if len(tix_raw) == 0:
                    return
                if self._local_query_native(q_label, q_seq, revcomp,
                                            tix_raw):
                    return
        tix_order, _counts = self.ranker.rank(q_seq)
        if len(tix_order) == 0:
            return
        if self.local:
            self._search_strand_local(q_label, q_seq, revcomp, tix_order,
                                      orf=orf)
            return
        if self._fast_loop_ok():
            self._search_strand_fast(q_label, q_seq, revcomp, tix_order, orf)
            return
        aligner = self.native if self.native is not None else self.hf
        aligner.set_a(q_seq)
        db = self.db
        fail_if_no_hsps = not options().flag("gaforce")
        for tix in tix_order.tolist():
            t_label = db.labels[tix]
            t_seq = db.seqs[tix]
            if self.accepter.reject_pair(q_label, q_seq, t_label, t_seq):
                continue  # not counted by terminator
            aligner.set_b(t_seq)
            if self.native is not None:
                path = self.native.global_align(
                    full_dp_always=self.ah.full_dp_always,
                    fail_if_no_hsps=fail_if_no_hsps)
            else:
                path = global_align(q_seq, t_seq, self.ap, self.ah, self.hf,
                                    full_dp_always=self.ah.full_dp_always,
                                    fail_if_no_hsps=fail_if_no_hsps,
                                    hole_kernel=self.hole_kernel)
            accept = False
            if path is not None:
                ar = AlignResult(query_label=q_label, target_label=t_label,
                                 query_seq=q_seq, target_seq=t_seq,
                                 path=path, nucleo=self.nucleo,
                                 target_index=tix, query_revcomp=revcomp)
                if orf is not None:
                    (ar.orf_frame, ar.orf_nuc_lo, ar.orf_nuc_hi,
                     ar.orf_nuc_l, ar.orf_nuc_seq) = orf
                accept = self.accepter.is_accept(ar)
                if accept:
                    self.hitmgr.append_hit(ar)
            if self.terminator.terminate(self.hitmgr, accept):
                return

    def _local_fast_ok(self) -> bool:
        """True when the whole per-query local loop can run in C:
        counter-only termination and -id/-maxid/-evalue-only gates."""
        cached = getattr(self, "_local_fast", None)
        if cached is not None:
            return cached
        ok = False
        la2 = self.local_aligner
        if la2 is not None and hasattr(la2.lib, "local_query_c"):
            o = options()
            a = self.accepter
            others = (a._f_self, a._f_notself, a._f_selfid,
                      a._min_sizeratio, a._mincols, a._maxgaps,
                      a._query_cov, a._max_query_cov, a._target_cov,
                      a._max_target_cov, a._maxdiffs, a._mindiffs,
                      a._abskew, a._any_pair_ratio, a.accept_all)
            ok = (not any(x for x in others)
                  and not o.filled("termid") and not o.filled("termidd")
                  and self.terminator.max_accepts > 0
                  and self.terminator.max_rejects > 0)
        if ok:
            # static target DB: one concat view for the C loop
            seqs = self.db.seqs
            n = len(seqs)
            lens = np.fromiter((len(s) for s in seqs), np.int64, n)
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            cat = np.concatenate(
                [np.ascontiguousarray(s) for s in seqs]) if n else \
                np.zeros(0, np.uint8)
            la2._dbv = (cat, offs)
            la2._lq_hsp = np.empty(64 * 4, np.int32)
            la2._lq_tix = np.empty(64, np.int32)
            la2._lq_raw = np.empty(64, np.float64)
            la2._lq_poff = np.empty(65, np.int64)
            la2._lq_pcap = 1 << 16
            la2._lq_paths = np.empty(la2._lq_pcap, np.uint8)
            la2._lq_cap = 64
        self._local_fast = ok
        return ok

    def _local_query_native(self, q_label, q_seq, revcomp,
                            tix_order) -> bool:
        """One C call for the whole local query (local_query_c)."""
        import ctypes
        la2 = self.local_aligner
        lib = la2.lib
        a = self.accepter
        q = np.ascontiguousarray(q_seq)
        la2.query_seq = q
        la2.min_ungapped = float(np.float32(
            la2.es.min_ungapped_raw_score(len(q))))
        cat, offs = la2._dbv
        tix = tix_order if (tix_order.dtype == np.uint32
                            and tix_order.flags["C_CONTIGUOUS"]) else \
            np.ascontiguousarray(tix_order, dtype=np.uint32)
        ctl = getattr(la2, "_ctl_c", None)
        if ctl is None:
            from ..alpha import (CHAR_TO_LETTER_NUCLEO,
                                 CHAR_TO_LETTER_AMINO)
            ctl = la2._ctl_c = np.ascontiguousarray(
                CHAR_TO_LETTER_NUCLEO if la2.nucleo
                else CHAR_TO_LETTER_AMINO)
        mm = getattr(la2, "_match_u8", None)
        if mm is None:
            from ..alpha import MATCH_MX_NUCLEO, MATCH_MX_AMINO
            mm = la2._match_u8 = np.ascontiguousarray(
                (MATCH_MX_NUCLEO if la2.nucleo
                 else MATCH_MX_AMINO).astype(np.uint8))
        max_evalue = options().flt("evalue")
        while True:
            n = lib.local_query_c(
                la2.scratch, getattr(la2, "_es_scratch", None)
                or self._ensure_la2_es(),
                q.ctypes.data, len(q),
                cat.ctypes.data, offs.ctypes.data,
                tix.ctypes.data, len(tix),
                ctl.ctypes.data, 4 if la2.nucleo else 20,
                la2.word_length,
                la2._mx_ptr, mm.ctypes.data,
                la2.ah.xdrop_u, la2.ah.xdrop_g,
                la2.ap.local_open, la2.ap.local_ext,
                la2.min_ungapped, la2.es.gapped_lambda,
                la2.es.log_gapped_k, la2.es.db_size, max_evalue,
                a._id if a._id is not None else 0.0,
                int(a._id is not None),
                a._maxid if a._maxid is not None else 0.0,
                int(a._maxid is not None),
                self.terminator.max_accepts, self.terminator.max_rejects,
                la2._lq_cap,
                la2._lq_tix.ctypes.data, la2._lq_hsp.ctypes.data,
                la2._lq_raw.ctypes.data,
                la2._lq_paths.ctypes.data, la2._lq_pcap,
                la2._lq_poff.ctypes.data)
            if n == -5:
                la2._lq_cap *= 2
                la2._lq_pcap *= 2
                la2._lq_hsp = np.empty(la2._lq_cap * 4, np.int32)
                la2._lq_tix = np.empty(la2._lq_cap, np.int32)
                la2._lq_raw = np.empty(la2._lq_cap, np.float64)
                la2._lq_poff = np.empty(la2._lq_cap + 1, np.int64)
                la2._lq_paths = np.empty(la2._lq_pcap, np.uint8)
                continue
            if n == -4:
                return False    # >64 hits on one target: python fallback
            break
        db = self.db
        hs = la2._lq_hsp
        po = la2._lq_poff
        pb = la2._lq_paths
        for k in range(n):
            t_ix = int(la2._lq_tix[k])
            loi, loj, leni, lenj = (int(v) for v in hs[4 * k:4 * k + 4])
            path = pb[int(po[k]):int(po[k + 1])].tobytes().decode("ascii")
            raw = float(la2._lq_raw[k])
            ar = AlignResult(
                query_label=q_label, target_label=db.labels[t_ix],
                query_seq=q, target_seq=db.seqs[t_ix], path=path,
                nucleo=la2.nucleo, local=True, loi=loi, loj=loj,
                raw_score=raw,
                evalue=la2.es.raw_to_evalue(raw, len(q), True),
                target_index=t_ix, query_revcomp=revcomp)
            ar.leni_local = leni
            ar.lenj_local = lenj
            ar.bit_score = la2.es.raw_to_bit(raw, True)
            self.hitmgr.append_hit(ar)
        return True

    def _ensure_la2_es(self):
        la2 = self.local_aligner
        if getattr(la2, "_es_scratch", None) is None:
            la2._es_scratch = la2.lib.engine_scratch_create()
        return la2._es_scratch

    def _search_strand_local(self, q_label: str, q_seq: np.ndarray,
                             revcomp: bool, tix_order, orf=None) -> None:
        """Local branch of Searcher::Align (src/searcher.cpp:26-50): one
        AlignMulti per target; the terminator is fed once per target with
        accept = any AR accepted."""
        la2 = self.local_aligner
        if orf is None and self._local_fast_ok() \
                and self._local_query_native(q_label, q_seq, revcomp,
                                             tix_order):
            return
        la2.set_query(q_label, q_seq)
        db = self.db
        for tix in tix_order.tolist():
            t_label = db.labels[tix]
            t_seq = db.seqs[tix]
            if self.accepter.reject_pair(q_label, q_seq, t_label, t_seq):
                continue  # not counted by terminator
            ars = la2.align_multi(t_label, t_seq)
            any_accept = False
            for ar in ars:
                ar.target_index = tix
                ar.query_revcomp = revcomp
                if orf is not None:
                    (ar.orf_frame, ar.orf_nuc_lo, ar.orf_nuc_hi,
                     ar.orf_nuc_l, ar.orf_nuc_seq) = orf
                if self.accepter.is_accept(ar):
                    any_accept = True
                    self.hitmgr.append_hit(ar)
            if self.terminator.terminate(self.hitmgr, any_accept):
                return


def search_file(cmd: str, query_path: str, db: SeqDB,
                on_query_done: Callable, hole_kernel=None,
                index=None) -> SearchContext:
    """Stream queries from file through the search; call
    on_query_done(label, seq, hits) per query in input order."""
    ctx = SearchContext.build(cmd, db, hole_kernel=hole_kernel, index=index)
    o = options()
    strand_both = False
    if ctx.nucleo:
        # StrandIsBoth (src/search.cpp:23-34): -strand required for nt DBs
        if not o.filled("strand"):
            raise SystemExit("Must specify -strand plus or both with nt db")
        s = o.str("strand")
        if s == "both":
            strand_both = True
        elif s != "plus":
            raise SystemExit("Invalid -strand, must be plus or both")
    # GetXlat (src/search.cpp:44-49): nt query vs aa DB => 6-frame ORFs
    xlat = (not ctx.nucleo) and file_is_nucleo(query_path)
    # the reference does NOT length-filter search queries (minseqlength
    # is consumed only by fastx_truncate, src/fastxtruncate.cpp)
    from .. import progress
    n_threads = requested_thread_count()
    if n_threads > 1 and not xlat and not ctx.local:
        _search_file_threaded(ctx, cmd, query_path, db, on_query_done,
                              strand_both, n_threads)
        return ctx
    progress.start("Searching")
    n_q = 0
    n_hit = 0
    for label, seq, _qual in read_fastx(query_path, stream=True):
        if xlat:
            hits = ctx.search_query_xlat(label, seq)
        else:
            hits = ctx.search_query(label, seq, revcomp=strand_both)
        n_q += 1
        if hits:
            n_hit += 1
        progress.tick(n_q, 0)
        on_query_done(label, seq, hits)
        ctx.hitmgr.on_query_done(label, None)
    progress.done(f"{n_q} queries, {n_hit} with hits")
    return ctx


def _search_file_threaded(ctx, cmd, query_path, db, on_query_done,
                          strand_both, n_threads) -> None:
    """Thread fan-out over queries (the reference's per-thread Searcher
    scheme, src/search.cpp:51-128): each worker owns its ranker/aligner
    scratch; the DB and posting index are shared read-only; results are
    delivered to the sinks in input order.  The hot per-query work (rank
    + align + accept) runs in the C library, which releases the GIL."""
    import threading
    from ..config import options as _options, set_options
    from .. import progress

    main_opts = _options()
    records = list(read_fastx(query_path, stream=True))
    results: List = [None] * len(records)
    nxt = [0]
    lock = threading.Lock()
    ready = threading.Condition(lock)   # signalled per completed query
    ctx.index._flatten()   # freeze the LSM tiers before sharing

    errors: List = []

    def worker():
        try:
            set_options(main_opts)
            wctx = SearchContext.build(cmd, db, index=ctx.index)
            while True:
                with lock:
                    i = nxt[0]
                    if i >= len(records):
                        return
                    nxt[0] = i + 1
                label, seq, _qual = records[i]
                hits = list(
                    wctx.search_query(label, seq, revcomp=strand_both))
                with ready:
                    results[i] = hits
                    ready.notify_all()
        except BaseException as e:   # surface worker failures
            with ready:
                errors.append(e)
                nxt[0] = len(records)
                ready.notify_all()

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    progress.start("Searching")
    n_hit = 0
    for i, (label, seq, _qual) in enumerate(records):
        with ready:
            while results[i] is None and not errors:
                ready.wait(timeout=1.0)
                if results[i] is None and not errors and \
                        not any(t.is_alive() for t in threads):
                    break
            if errors:
                raise errors[0]
            hits = results[i] or []
        if hits:
            n_hit += 1
        progress.tick(i + 1, len(records))
        on_query_done(label, seq, hits)
    for t in threads:
        t.join()
    progress.done(f"{len(records)} queries, {n_hit} with hits")
