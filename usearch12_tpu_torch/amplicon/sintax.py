"""SINTAX k-mer bootstrap taxonomy classifier (src/sintaxsearcher.cpp)
and the -sintax command.

100 bootstrap iterations; each samples 32 query unique words (private LCG,
Numerical-Recipes constants, seeded from -randseed per query) and
scatter-adds their UDB postings rows; the arg-max target (ties broken with
the reference's global lagged-MWC RNG) votes for its taxonomy string.
Per-rank confidence = cumulative-product bootstrap fraction.

SintaxRun is the command's loaded state (the DB, its index, the classifier
and, where chosen, the incidence on the card), which classifies one query
file a call; sintax() builds one and makes one call.  SintaxClassifier is
the host path (C per window, numpy per query).  The boots run on the card
(amplicon/sintax_device.py:SintaxTorchClassifier) when -sintax_device asks
for it, or, unless -no_sintax_device is given, when the DB has at least
AUTO_MIN_TARGETS targets (AUTO_MIN_SERVER_TARGETS when a resident server
answers and the caller passed no device).  With no
device passed the boots go to the resident server (device_server.py),
else, saying why on stderr, to the card in this process
(card.py:open_card).  Either way nothing falls back: a build,
launch or memory error on the card, or a failure of the server, raises.
Runs that the device path cannot take (ineligible(): -self, a hashed
index, an incidence over MAX_INCIDENCE_BYTES) run on the host whatever
the flags say, and the reason goes into the USEARCH_DEVICE_STATS record.
torch is imported only when the card is chosen in this process.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple

import json
import os

import numpy as np

from .. import obs
from ..config import options
from ..io.seqdb import SeqDB
from ..index.udb import UDBIndex, UDBParams

if TYPE_CHECKING:
    from ..device import DeviceLike

M32 = 0xFFFFFFFF


class GlobalRand:
    """The reference's global RNG (src/myutils.cpp:1757-1838): lagged
    multiply-with-carry seeded from a small LCG."""

    def __init__(self, seed: int) -> None:
        state = seed & M32
        for _ in range(10):
            state = (state * 214013 + 2531011) & M32
        x = []
        for _ in range(5):
            state = (state * 214013 + 2531011) & M32
            x.append(state)
        self.x = x
        for _ in range(100):
            self._inc()

    def _inc(self) -> None:
        x = self.x
        s = (2111111111 * x[3] + 1492 * x[2] + 1776 * x[1]
             + 5115 * x[0] + x[4])
        x[3] = x[2]
        x[2] = x[1]
        x[1] = x[0]
        x[4] = (s >> 32) & M32
        x[0] = s & M32

    def randu32(self) -> int:
        self._inc()
        return self.x[0]


def _next_rand(r: int) -> int:
    """Per-query boot LCG (src/sintaxsearcher.cpp:77-82)."""
    return (1664525 * r + 1013904223) & M32


def get_tax_str(label: str) -> str:
    for field in label.split(";"):
        if field.startswith("tax="):
            return field[4:]
    return ""


def tax_names(tax_str: str) -> List[str]:
    names = [n for n in tax_str.split(",")]
    for n in names:
        if len(n) < 3 or n[1] != ":":
            raise SystemExit(f"Missing x: in tax={tax_str}")
    return names


def name_in_tax_str(tax_str: str, name: str) -> bool:
    """NameIsInTaxStr (src/tax.cpp:299-308): substring match terminated by
    ',' or end."""
    n = tax_str.find(name)
    if n < 0:
        return False
    rest = tax_str[n + len(name):]
    return rest == "" or rest[0] == ","


def tally_strand(tax_id, winners):
    """(tax ids, counts) of one strand's boot winners in CountMapToVecs'
    order, in Python: tax ids are assigned in lexicographic order, so
    np.unique's ascending ids reproduce its map order exactly, and
    QuickSortOrderDesc then orders them by count (the C runtime's
    sx_tally)."""
    from ..search.hitmgr import quick_sort_order
    uti, ucnt = np.unique(tax_id[winners], return_counts=True)
    order = quick_sort_order(ucnt.tolist(), desc=True)
    return [int(uti[i]) for i in order], [int(ucnt[i]) for i in order]


def tally_tuples(B, ntax, ids, cnts, twc, strand):
    """Per query (strand, tax ids, counts, last top word count) from a
    window's tally arrays as the C runtime writes them (sintax_window_c,
    sintax_tally_window_c): ntax, twc, strand (n,); ids, cnts (n * B,),
    query i's ordered tally in the first ntax[i] of its B slots (only
    those are converted: most queries fill a few)."""
    keep = np.arange(B) < ntax[:, None]
    ids_l = ids.reshape(len(ntax), B)[keep].tolist()
    cnts_l = cnts.reshape(len(ntax), B)[keep].tolist()
    return [(chr(c) if c else "+", ids_l[e - k:e], cnts_l[e - k:e], t)
            for k, e, t, c in zip(ntax.tolist(), np.cumsum(ntax).tolist(),
                                  twc.tolist(), strand.tolist())]


class SintaxClassifier:
    _es = None
    _lib = False

    def __init__(self, db: SeqDB, index: UDBIndex, grand: GlobalRand) -> None:
        self.db = db
        self.index = index
        self.grand = grand
        self.tax_strs = [get_tax_str(l) for l in db.labels]
        o = options()
        self.boots = o.uns("boots")
        self.cutoff = o.flt("sintax_cutoff")
        self.randseed = o.uns("randseed")
        s = o.str("boot_subset", "") if o.filled("boot_subset") else "32"
        if not s:
            s = "32"
        if s.startswith("/"):
            self.boot_subset_divide = True
            self.boot_subset = int(s[1:])
        else:
            self.boot_subset_divide = False
            self.boot_subset = int(s)
        # flatten postings for the shuffle counting
        self.index._flatten()
        # numeric taxonomy structures so classify() avoids per-query
        # string work: distinct tax strings, their lexicographic rank,
        # per-tax name lists, and a name-containment matrix with
        # NameIsInTaxStr semantics (src/tax.cpp:299-308)
        uniq = sorted(set(self.tax_strs))
        tax_to_id = {t: i for i, t in enumerate(uniq)}
        self._tax_id = np.array([tax_to_id[t] for t in self.tax_strs],
                                dtype=np.int32)
        self._uniq_tax = uniq          # index = tax id, already lex-sorted
        def _names_or_none(t):
            try:
                return tax_names(t) if t else []
            except SystemExit:
                return None    # malformed: only an error if it ever wins
        self._tax_names = [_names_or_none(t) for t in uniq]
        all_names = sorted({n for ns in self._tax_names if ns
                            for n in ns})
        name_to_id = {n: i for i, n in enumerate(all_names)}
        self._name_ids = [np.array([name_to_id[n] for n in ns], np.int32)
                          if ns is not None else None
                          for ns in self._tax_names]
        k, nn = len(uniq), len(all_names)
        contains = np.zeros((k, nn), dtype=bool)
        for ti, t in enumerate(uniq):
            for ni, n in enumerate(all_names):
                if name_in_tax_str(t, n):
                    contains[ti, ni] = True
        self._contains = contains

    def restart_rng(self) -> None:
        """The tie-break RNG back at -randseed: grand, and the native
        path's copy of its state (_gx) in place, where that exists."""
        self.grand = GlobalRand(self.randseed)
        gx = getattr(self, "_gx", None)
        if gx is not None:
            gx[:] = self.grand.x

    def _run_boots(self, uw, nuw, seq_count, starts, sizes, postings, m):
        """All boots' (winner index, word count): native when available
        (sintax_boots_c — both RNGs bit-exact, plus in-C winner-tax
        tally), numpy fallback.  The native path also sets
        self._c_tally = (tax_ids, counts, top_word_count)."""
        lib = self._lib
        if lib is False:
            from ..native import get_lib
            lib = self._lib = get_lib()
        self._c_tally = None
        if lib is not None and postings is not None:
            if self._es is None:
                es = self._es = lib.engine_scratch_create()
                self._out_ti = np.empty(self.boots, np.int32)
                self._out_u = np.empty(self.boots, np.int32)
                self._out_txi = np.empty(self.boots, np.int32)
                self._out_txc = np.empty(self.boots, np.int32)
                self._out_twc = np.empty(1, np.int32)
                # the global RNG state lives in _gx between native calls;
                # grand.x is only synced on demand (sync_grand)
                self._gx = np.array(self.grand.x, dtype=np.uint64)
                # args that never change across queries, prebound once
                self._pre = (es, starts.ctypes.data, postings.ctypes.data,
                             seq_count, self.boots, self.randseed,
                             self._gx.ctypes.data,
                             self._tax_id.ctypes.data,
                             self._out_ti.ctypes.data,
                             self._out_u.ctypes.data,
                             self._out_txi.ctypes.data,
                             self._out_txc.ctypes.data,
                             self._out_twc.ctypes.data)
            (es, p_st, p_po, p_sc, p_boots, p_seed, p_gx, p_tax,
             p_ti, p_u, p_txi, p_txc, p_twc) = self._pre
            uw_c = uw if (uw.dtype == np.int64 and
                          uw.flags["C_CONTIGUOUS"]) else \
                np.ascontiguousarray(uw, dtype=np.int64)
            ntax = lib.sintax_boots_c(
                es, uw_c.ctypes.data, nuw, p_st, p_po, p_sc,
                p_boots, m, p_seed, p_gx, p_tax, p_ti, p_u,
                p_txi, p_txc, p_twc)
            if ntax > 0:
                self._c_tally = (self._out_txi[:ntax].tolist(),
                                 self._out_txc[:ntax].tolist(),
                                 int(self._out_twc[0]))
            return self._out_ti, self._out_u
        # numpy fallback: draw picks up front, one scatter-add, per-boot
        # tie-break with the global RNG
        r = self.randseed
        picks = np.empty(self.boots * m, dtype=np.int64)
        for k in range(self.boots * m):
            r = _next_rand(r)
            picks[k] = r % nuw
        words = uw[picks]
        seg_sizes = sizes[words]
        total = int(seg_sizes.sum())
        U = np.zeros((self.boots, seq_count), dtype=np.int32)
        if total:
            base = np.repeat(starts[words], seg_sizes)
            offs = np.arange(total) - np.repeat(
                np.cumsum(seg_sizes) - seg_sizes, seg_sizes)
            flat = postings[base + offs]
            pick_boot = np.arange(self.boots * m) // m
            boot_ids = np.repeat(pick_boot, seg_sizes)
            np.add.at(U, (boot_ids, flat), 1)
        top_us = U.max(axis=1) if seq_count else np.zeros(self.boots, int)
        out_ti = np.zeros(self.boots, np.int32)
        out_u = np.zeros(self.boots, np.int32)
        for boot in range(self.boots):
            top_u = int(top_us[boot])
            if top_u == 0:
                tops = np.arange(seq_count, dtype=np.int64)
            else:
                tops = np.nonzero(U[boot] == top_u)[0]
            rr = self.grand.randu32() % len(tops)
            out_ti[boot] = int(tops[rr])
            out_u[boot] = top_u
        return out_ti, out_u

    def classify_window(self, seqs, both: bool):
        """Window of queries through sintax_window_c: per query the
        whole classify pipeline (both strands, unique words, boots,
        tally, strand vote) in one C call.  Returns a list of
        (strand_char, ids, counts, last_twc) or None (no native lib /
        hashed dictionary)."""
        lib = self._lib
        if lib is False:
            from ..native import get_lib
            lib = self._lib = get_lib()
        if (lib is None or self.index.params.hashed
                or self.index._postings is None):
            return None
        import ctypes
        n = len(seqs)
        if n == 0:
            return []
        if self._es is None:
            self._es = lib.engine_scratch_create()
            self._gx = np.array(self.grand.x, dtype=np.uint64)
        params = self.index.params
        if getattr(self, "_win_ctl", None) is None:
            from ..alpha import (CHAR_TO_LETTER_NUCLEO,
                                 CHAR_TO_LETTER_AMINO, CHAR_TO_COMP_CHAR,
                                 IS_LOWER)
            ctl = (CHAR_TO_LETTER_NUCLEO if params.is_nucleo
                   else CHAR_TO_LETTER_AMINO).copy()
            ctl[IS_LOWER] = 0xFF
            self._win_ctl = np.ascontiguousarray(ctl)
            self._win_comp = np.ascontiguousarray(CHAR_TO_COMP_CHAR)
        lens = np.fromiter((len(s) for s in seqs), np.int64, n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        qcat = np.concatenate(
            [np.ascontiguousarray(s) for s in seqs]) if n else \
            np.zeros(0, np.uint8)
        B = self.boots
        out_ntax = np.empty(n, np.int32)
        out_ids = np.empty(n * B, np.int32)
        out_cnts = np.empty(n * B, np.int32)
        out_twc = np.empty(n, np.int32)
        out_strand = np.empty(n, np.uint8)
        lib.sintax_window_c(
            self._es, qcat.ctypes.data, offs.ctypes.data, n,
            self._win_comp.ctypes.data, int(both),
            self._win_ctl.ctypes.data, params.alpha_size,
            params.word_length, params.slot_count,
            self.index._starts.ctypes.data,
            self.index._postings.ctypes.data, self.index.seq_count,
            B, self.boot_subset, int(self.boot_subset_divide),
            self.randseed, self._gx.ctypes.data,
            self._tax_id.ctypes.data,
            out_ntax.ctypes.data, out_ids.ctypes.data,
            out_cnts.ctypes.data, out_twc.ctypes.data,
            out_strand.ctypes.data)
        return tally_tuples(B, out_ntax, out_ids, out_cnts, out_twc,
                            out_strand)

    def classify(self, q_seq: np.ndarray):
        """Returns (pred names, Ps, top_word_count)."""
        params = self.index.params
        uw = params.unique_words(q_seq)
        nuw = len(uw)
        if nuw < 8:
            return [], [], 0

        seq_count = self.index.seq_count
        starts = self.index._starts
        sizes = self.index._sizes
        postings = self.index._postings
        m = (nuw // self.boot_subset if self.boot_subset_divide
             else self.boot_subset)

        boot_ti, boot_u = self._run_boots(uw, nuw, seq_count, starts,
                                          sizes, postings, m)
        if self._c_tally is not None:
            # already in final CountMapToVecs order (C-side quicksort)
            ids, counts, top_word_count = self._c_tally
        else:
            top_word_count = int(boot_u.max()) if self.boots else 0
            ids, counts = tally_strand(self._tax_id, boot_ti)

        pred, ps = self.pred_from_tally(ids, counts)
        return pred, ps, top_word_count

    def pred_from_tally(self, ids, counts):
        """pred names + cumulative Ps from the ordered (tax id, count)
        tally (the tail of Classify, src/sintaxsearcher.cpp:200-228)."""
        top_id = ids[0]
        top_count = counts[0]
        pred = self._tax_names[top_id]
        if pred is None:             # malformed winner: reference dies here
            pred = tax_names(self._uniq_tax[top_id])
        name_ids = self._name_ids[top_id]
        if len(ids) > 1 and len(name_ids):
            other = self._contains[np.array(ids[1:], np.int64)][:, name_ids]
            extra = (np.array(counts[1:],
                              np.int64)[:, None] * other).sum(axis=0)
        else:
            extra = np.zeros(len(name_ids), np.int64)
        ps = []
        prod_p = 1.0
        for i, _name in enumerate(pred):
            cnt = top_count + int(extra[i])
            # the reference is compiled -ffast-math: cnt/BOOT_ITERS is
            # emitted as cnt * (1/BOOT_ITERS), which differs in the last
            # ulp and can flip the 4th printed decimal
            p = cnt * (1.0 / self.boots)
            prod_p *= p
            ps.append(prod_p)
        return pred, ps


# Auto gate: the card takes a DB of at least this many targets.  Measured
# on an H100 (700 W) with the port's command line as a fresh process per
# run, 1,500 queries of 248 nt, -strand both: host and card take equal
# time at 63,312 targets (PERF.md).  The card's fixed cost there is
# torch's import and the CUDA start (about 8 s on that machine); the
# classification itself is about 11x faster on the card at 60,000.
AUTO_MIN_TARGETS = 64000
# The same gate when a resident server (device_server.py) answers and the
# caller passed no device: the run then pays neither of those costs.  On
# the same card and workload at 60,000 targets a command run through a
# warm server beat the host path in every turn (7.54-7.74 s against
# 16.60-17.15 s; chip_smoke.py's phase 11, PERF.md).  Smaller DBs were not
# measured.
AUTO_MIN_SERVER_TARGETS = 60000
WINDOW = 512
# largest dense (V, T) int8 incidence the card path takes; the JAX
# package's TPU limit, not yet measured on the card
MAX_INCIDENCE_BYTES = 6 << 30


def ineligible(sc: SintaxClassifier) -> Optional[str]:
    """Why the device path cannot take this run, or None, with the reason
    for each rule: -self, a hashed word index, no postings, an incidence
    over MAX_INCIDENCE_BYTES."""
    index = sc.index
    if options().flag("self"):
        return "-self"
    if index.params.hashed:
        return "hashed word index"
    index._flatten()
    if index._postings is None:
        return "no postings"
    nbytes = index.params.slot_count * max(index.seq_count, 1)
    limit = MAX_INCIDENCE_BYTES
    if nbytes > limit:
        return f"incidence of {nbytes} bytes over {limit}"
    return None


def choose_device(cls: SintaxClassifier,
                  device: DeviceLike = None) -> Tuple[bool, str]:
    """(run the boots on the card, why).  With no `device` passed, a live
    resident server lowers the automatic gate to AUTO_MIN_SERVER_TARGETS
    (it is asked with a ping, before anything imports torch)."""
    o = options()
    forced, refused = o.flag("sintax_device"), o.flag("no_sintax_device")
    why = ineligible(cls)
    if why is not None:
        return False, f"ineligible: {why}"
    if forced:
        return True, "-sintax_device"
    if refused:
        return False, "-no_sintax_device"
    n = cls.index.seq_count
    if n >= AUTO_MIN_TARGETS:
        return True, f"auto: {n} >= {AUTO_MIN_TARGETS} targets"
    if (device is None and AUTO_MIN_SERVER_TARGETS is not None
            and n >= AUTO_MIN_SERVER_TARGETS):
        from ..card import warm_server
        if warm_server() is not None:
            return True, (f"auto: {n} >= {AUTO_MIN_SERVER_TARGETS} targets "
                          "and a live device server")
    return False, f"auto: {n} < {AUTO_MIN_TARGETS} targets"


def _row(label, c_strand, pred, ps, last_twc, cutoff) -> str:
    """One -tabbedout line."""
    if last_twc == 0:
        return label + "\t*\t*\t*\n"
    out = []
    for i, (n, p) in enumerate(zip(pred, ps)):
        if p < cutoff:
            if i == 0:
                out.append("*")
            break
        out.append(n)
    return "".join([label, "\t",
                    ",".join(f"{n}({p:.4f})" for n, p in zip(pred, ps)),
                    "\t", c_strand, "\t",
                    ",".join(out) if out != ["*"] else "*", "\n"])


class SintaxRun:
    """The -sintax command kept loaded: the -db database and its word
    index, the classifier and, where choose_device() takes the card, the
    classifier of the boots there with its incidence (on the card that
    card.open_card gives for `device`), all set up once from the options;
    then classify_file() classifies one query file a call.

    Each call restarts the tie-break RNG at -randseed (the classifier's
    GlobalRand and the native path's copy of its state), so its rows are
    the bytes one fresh sintax command writes for the same database and
    query file.

    dev_stats holds the spans and counters of every call (obs.py):
    sintax_parse (reading a window's records), sintax_tally (on the card's
    path the host tally, the strand vote and the rows; on the host path the
    rows) and the counter sintax_queries, a window each; on the card's path
    also SintaxTorchClassifier's (amplicon/sintax_device.py).  While
    torch.profiler records, each span is a usearch.* range."""

    def __init__(self, device: DeviceLike = None) -> None:
        from ..index.udbfile import load_db
        o = options()
        db, index = load_db(o.str("db"))
        if index is None:
            index = UDBIndex.from_seqdb(db)
        if db.get_is_nucleo():
            strand = o.str("strand", "")
            if not strand:
                raise SystemExit(
                    "Must specify -strand plus or both with nt db")
            self.both = strand == "both"
        else:
            self.both = False   # amino DB: single plus-strand classify
        self.cls = cls = SintaxClassifier(db, index,
                                          GlobalRand(o.uns("randseed")))
        self.cutoff = o.flt("sintax_cutoff")
        self.on_card, self.reason = choose_device(cls, device)
        self.dev_cls = None
        if self.on_card:
            from ..card import open_card
            from .sintax_device import SintaxTorchClassifier
            self.dev_cls = SintaxTorchClassifier(cls, open_card(device))
        # the window path: the card's, or the native library's
        self.windowed = (self.dev_cls is not None
                         or cls.classify_window([], self.both) is not None)
        self.dev_stats = {} if self.dev_cls is None else self.dev_cls.stats
        self.seq = 0

    def classify_file(self, query_path: Optional[str], out) -> int:
        """Classify every record of query_path, writing the -tabbedout rows
        to out (a text file, or None); returns the number of queries."""
        self.cls.restart_rng()
        self.seq += 1
        if not self.windowed:
            return _classify_each(self.cls, query_path, self.both,
                                  self.cutoff, out)
        trace = obs.profiling()
        if self.dev_cls is not None:
            self.dev_cls.trace, self.dev_cls.seq = trace, self.seq
        return self._windows(query_path, out, trace)

    def _windows(self, query_path, out, trace: bool) -> int:
        """Windows of WINDOW queries: the card's boots, then its tally and
        the rows in one sintax_tally span; or the native library's
        classify_window, then the rows in that span."""
        from ..io.fastx import read_fastx
        cls, st, seq = self.cls, self.dev_stats, self.seq
        cutoff = self.cutoff
        records = read_fastx(query_path, stream=True)
        n = 0
        while True:
            labels, seqs = [], []
            with obs.span(st, "sintax_parse", trace, seq):
                for label, s, _q in records:
                    if len(s) == 0:
                        continue
                    labels.append(label)
                    seqs.append(s)
                    if len(seqs) >= WINDOW:
                        break
            if not seqs:
                return n
            n += len(seqs)
            obs.add(st, "sintax_queries", len(seqs))
            if self.dev_cls is not None:
                boots = self.dev_cls.boots(seqs, self.both)
            else:
                res = cls.classify_window(seqs, self.both)
            with obs.span(st, "sintax_tally", trace, seq):
                if self.dev_cls is not None:
                    res = self.dev_cls.tally(*boots, self.both)
                if out is None:
                    continue
                lines = []
                for label, (c_strand, ids, counts, last_twc) in zip(labels,
                                                                     res):
                    if last_twc == 0 or not ids:
                        lines.append(_row(label, c_strand, [], [], 0,
                                          cutoff))
                    else:
                        pred, ps = cls.pred_from_tally(ids, counts)
                        lines.append(_row(label, c_strand, pred, ps,
                                          last_twc, cutoff))
                out.write("".join(lines))


def sintax(query_path: Optional[str], device: DeviceLike = None) -> None:
    """-sintax: classify every query against -db through one SintaxRun;
    `device` is resolved only when the card is chosen."""
    o = options()
    run = SintaxRun(device)
    f = open(o.str("tabbedout"), "w") if o.filled("tabbedout") else None
    try:
        n = run.classify_file(query_path, f)
    finally:
        if f:
            f.close()
    if run.windowed:
        _write_stats(run.dev_cls is not None, run.reason, n,
                     run.cls.index.seq_count, run.dev_stats)


def _classify_each(cls, query_path, both, cutoff, f) -> int:
    """One query at a time, where no window path exists (no native
    library, or a hashed index); returns the number of queries."""
    from ..alpha import revcomp
    from ..io.fastx import read_fastx
    n = 0
    for label, seq, _q in read_fastx(query_path, stream=True):
        if len(seq) == 0:
            continue
        n += 1
        pred_f, ps_f, twc_f = cls.classify(seq)
        if both:
            pred_r, ps_r, twc_r = cls.classify(revcomp(seq))
        else:
            pred_r, ps_r, twc_r = [], [], 0
        if twc_f >= twc_r:
            c_strand, pred, ps = "+", pred_f, ps_f
        else:
            c_strand, pred, ps = "-", pred_r, ps_r
        # the reference's '*' row reads the last classified strand's
        # top word count (src/sintaxsearcher.cpp:51-72, WriteTabbed)
        last_twc = twc_r if both else twc_f
        if f is not None:
            f.write(_row(label, c_strand, pred, ps, last_twc, cutoff))
    return n


def _write_stats(device: bool, reason: str, queries: int, targets: int,
                 stats: dict) -> None:
    """The USEARCH_DEVICE_STATS record of the run, with the reason for the
    device choice and the run's spans and counters (SintaxRun.dev_stats)."""
    path = os.environ.get("USEARCH_DEVICE_STATS")
    if path:
        with open(path, "a") as sf:
            sf.write(json.dumps({"cmd": "sintax", "device": device,
                                 "reason": reason, "queries": queries,
                                 "targets": targets, **stats}) + "\n")
