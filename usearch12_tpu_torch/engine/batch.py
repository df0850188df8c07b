"""Batch search engine orchestrator.

Pipeline per query window (default 8192 records):

  1. bulk FASTA parse (fasta_parse_c) — label/seq offset arrays, no
     per-record Python objects
  2. rank_batch_c — USORT candidate ranking for every (record, strand)
     job, capped at K = maxaccepts + maxrejects (the most the lazy loop
     can consume, SURVEY.md §7 "early termination economics")
  3. candidate rounds: chain_batch_c HSP-chains the next candidate(s) of
     every live job; small inter-HSP holes are banded-NW'd inline in C,
     large holes are batched to the card (ops/wavefront_nw.py:
     TorchWaveAligner) when the engine has a device
  4. finish_replay_c — splice paths, compute stats, replay the exact
     accept/terminate loop; jobs that terminated drop out
  5. emit hits per record in input order

Outputs are bit-identical to the serial driver (search/driver.py); the
parity suite runs both.  Reference semantics: src/search.cpp:89-141,
src/udbusortedsearcher.cpp:122-152, src/globalalignmem.cpp:129-236.

The card (card.py) is the one passed to the constructor (or the
LocalCard of a torch.device passed there), or the one that its
card_factory returns when a window first wants it: the factory runs only
then, or, for a file holding a sequence of 2,000 nt or more, in a warm-up
thread started with the run.  The card is never dropped: a build, launch
or memory error on it, or a failure of the server or of the factory,
raises.  Without either (-no_engine_device) every hole runs in the host C
kernel.  Holes whose band is wider than BW_DEV_MAX, and batches the
dispatch gate keeps on the host, run in the host C kernel too, and the
cells of each are counted in dev_stats.  torch is imported only when the
card is a LocalCard.

dev_stats also holds the stages of every run_file call (STAGES: the
request, the parse, the rank, each candidate round and its chain, holes
and replay, the emit, the save of the run's records), each as <stage>_ns
(host clock) and <stage>_n (obs.span; round_n counts the rounds), the
counts queries and pairs (candidate pairs chained), and, with a rank
override, its ranker's stages (ops/csr_host.py), and, where a LocalCard
aligns the holes, the hole DP's spans holedp_pack and holedp_collect (host
clock only), its launches' time on the card's stream holedp_device and its
counts holedp_pairs, holedp_launches and holedp_thread_launches
(ops/wavefront_nw.py:TorchWaveAligner.align).  The USEARCH_DEVICE_STATS
line that run_file appends carries them all.  While torch.profiler
records (-xprof, a benchmark's traced window) each stage is also a
"usearch.<stage>" range of the trace, nested under the ranges around it.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..card import as_card
from ..config import options
from ..io.seqdb import SeqDB
from ..scoring import AlnParams, AlnHeuristics
from ..index.udb import UDBIndex
from ..search.terminator import Terminator
from ..search.driver import fast_loop_eligible
from ..align.result import AlignResult
from ..native import GapParams, get_lib
from .. import obs, progress

_STAT_FIELDS = ("first_m_col", "last_m_col", "first_m_qpos",
                "first_m_tpos", "last_m_qpos", "last_m_tpos")

# perf-cache schema version: constants learned under one device-path
# architecture mislead the next, so a version bump retires the whole
# entry
MODEL_VERSION = 2
# DevicePerfModel's cold-start constants, measured on an NVIDIA H100 80GB
# HBM3 (700 W) by chip_smoke.py's perf-model phase (PERF.md section 6)
COLD_RTT = 1.3e-3        # s, one TorchWaveAligner dispatch of one short pair
COLD_UP_BW = 8.4e9       # bytes/s, pageable host memory to the card
COLD_DN_BW = 2.3e9       # bytes/s, the card to pageable host memory
COLD_DEV_RATE = 4.3e9    # cells/s, the slice's hole DP, host work included
COLD_WARM_TAX = 0.21     # s, first dispatch of a process over the second
# the stages a run_file call spans (dev_stats "<stage>_ns", "<stage>_n";
# "usearch.<stage>" ranges while torch.profiler records): the request
# holds the others; a round, each candidate round, holds its chain, holes
# and replay
STAGES = ("request", "parse", "rank", "round", "chain", "holes", "replay",
          "emit", "save")


class DevicePerfModel:
    """Self-tuning host-vs-device dispatch cost model for the hole DP.

    It predicts t_host = cells/host_rate against t_dev = rtt +
    up_bytes/up_bw + dn_bytes/dn_bw + cells/dev_rate, with constants
    learned from every measured dispatch and kept per device kind in a
    file of the port's own (CACHE), so the gate converges to the machine
    it runs on.  Until that file holds >= 2 steady observations the model
    calibrates itself with one probe dispatch (`should_probe`).  The
    first dispatch of a process also pays `warm_tax` (the kernel
    library's load and the first launches), learned likewise."""

    CACHE = os.path.join(tempfile.gettempdir(),
                         "usearch12_tpu_torch_perf.json")

    def __init__(self, platform: str):
        self.platform = f"{platform}/v{MODEL_VERSION}"
        # cold-start constants, measured on the card (chip_smoke.py's
        # perf-model phase): NVIDIA H100 80GB HBM3, 700 W, PCIe host link
        self.host_rate = 2.0e8        # cells/s, single-core C kernel
        self.rtt = COLD_RTT           # s per dispatch: launch + sync
        self.up_bw = COLD_UP_BW       # bytes/s host->device
        self.dn_bw = COLD_DN_BW       # bytes/s device->host
        self.dev_rate = COLD_DEV_RATE  # cells/s on the card
        self.warm = False             # the first dispatch pays warm_tax
        self.warm_tax = COLD_WARM_TAX  # s, library load + first launches
        self.n_obs = 0                # steady-state device observations
        self._probed = False          # one calibration probe per process
        self._load()

    def _load(self):
        import json
        try:
            with open(self.CACHE) as f:
                d = json.load(f).get(self.platform)
            if d:
                for k in ("host_rate", "rtt", "up_bw", "dn_bw",
                          "dev_rate", "warm_tax"):
                    if k in d and d[k] > 0:
                        setattr(self, k, float(d[k]))
                self.n_obs = int(d.get("n_obs", 0))
        except Exception:
            pass

    def save(self):
        import json
        try:
            try:
                with open(self.CACHE) as f:
                    all_d = json.load(f)
            except Exception:
                all_d = {}
            all_d[self.platform] = {
                k: getattr(self, k) for k in
                ("host_rate", "rtt", "up_bw", "dn_bw", "dev_rate",
                 "warm_tax", "n_obs")}
            tmp = self.CACHE + ".tmp"
            with open(tmp, "w") as f:
                json.dump(all_d, f)
            import os
            os.replace(tmp, self.CACHE)
        except Exception:
            pass

    def t_dev(self, cells: int, up_bytes: int, dn_bytes: int) -> float:
        return (self.rtt + up_bytes / self.up_bw + dn_bytes / self.dn_bw
                + cells / self.dev_rate)

    def t_host(self, cells: int) -> float:
        return cells / self.host_rate

    def device_wins(self, cells: int, up_bytes: int, dn_bytes: int,
                    dispatches_left: int) -> bool:
        td = self.t_dev(cells, up_bytes, dn_bytes)
        if not self.warm:
            td += self.warm_tax / max(1, dispatches_left)
        return td < self.t_host(cells)

    def should_probe(self, cells: int) -> bool:
        """One-shot calibration dispatch: with <2 steady observations
        under this model version, the constants are cold-start defaults
        or stale guesses — measure once instead of trusting them, but
        only when the workload is big enough (>=1s of predicted host
        work) that a mispredicted probe is amortizable."""
        if self.n_obs >= 2 or self._probed:
            return False
        if self.t_host(cells) < 1.0:
            return False
        self._probed = True
        return True

    def observe_host(self, cells: int, secs: float) -> None:
        if secs > 1e-5 and cells > 100000:
            self.host_rate = 0.7 * self.host_rate + 0.3 * (cells / secs)

    def observe_dev(self, cells: int, up_bytes: int, dn_bytes: int,
                    secs: float) -> None:
        """Attribute the measured wall time to the model's slowest term
        (scale that term so the predicted total matches the measured)."""
        if secs <= 1e-5:
            return
        pred = self.t_dev(cells, up_bytes, dn_bytes)
        if not self.warm:
            # first dispatch of the process: the excess over the steady
            # prediction IS the warm tax (jit/cache-load/backend init),
            # so learn it instead of folding it into the steady terms —
            # a stale 12s default otherwise vetoes the device forever
            # on single-window runs
            self.warm = True
            self.warm_tax = max(0.0, 0.7 * self.warm_tax
                                + 0.3 * max(0.0, secs - pred))
            return
        scale = secs / pred
        # geometric step toward the observation: a 30x misprediction
        # (polluted cache, relocated link) corrects within ~3 dispatches
        # instead of dozens, while near steady state (scale ~ 1) the
        # step stays proportional
        f = min(3.0, max(0.33, scale ** 0.5))
        self.rtt *= f
        self.up_bw /= f
        self.dn_bw /= f
        self.dev_rate /= f
        self.n_obs += 1


def _thread_count() -> int:
    """Requested worker-thread count: -threads when set, else
    min(10, cores) — GetRequestedThreadCount semantics
    (src/myutils.cpp:151-175)."""
    o = options()
    if o.filled("threads"):
        return max(1, int(o.uns("threads")))
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    return min(10, cores)


def engine_eligible(cmd: str, nucleo: bool, xlat: bool) -> bool:
    """True when the batch engine reproduces the serial driver exactly:
    global search, bounded terminator, -id-only acceptance."""
    o = options()
    if get_lib() is None or xlat:
        return False
    if cmd not in ("usearch_global", "otutab", "closed_ref"):
        return False
    if o.flag("quicksort"):
        return False   # C rank path implements count-sort order only
    from ..search.accepter import Accepter
    acc = Accepter(is_global=True)
    if not fast_loop_eligible(acc):
        return False
    term = Terminator(cmd)
    if term.max_accepts <= 0 or term.max_rejects <= 0:
        return False
    return True


class _Scratch:
    """Per-thread mutable engine state: C scratch objects plus the
    growable batch buffers.  One instance per worker thread lets the
    window pipeline run `-threads` windows concurrently (the reference
    model: one searcher object per thread, search.cpp:119-128) while
    every array the C calls write stays thread-private."""

    __slots__ = ("hf", "as_", "rs", "es", "seg_cap", "hole_cap",
                 "lit_cap", "hitpath_cap", "seg_kind", "seg_val",
                 "seg_val2", "hole_pair", "hole_aoff", "hole_boff",
                 "hole_alen", "hole_blen", "hole_cls", "lit_buf",
                 "keep_alive")

    def __init__(self, lib, ah, nucleo, sub_mx, ctl_aln) -> None:
        self.hf = lib.hsp_create(ah.hsp_word_length,
                                 4 if nucleo else 20, sub_mx, ctl_aln)
        self.as_ = lib.scratch_create()
        self.rs = lib.rank_scratch_create()
        self.es = lib.engine_scratch_create()
        self.seg_cap = 1 << 16
        self.hole_cap = 1 << 12
        self.lit_cap = 1 << 20
        self.hitpath_cap = 1 << 20
        self.keep_alive = None
        self.alloc_round_bufs()

    def alloc_round_bufs(self) -> None:
        self.seg_kind = np.empty(self.seg_cap, np.uint8)
        self.seg_val = np.empty(self.seg_cap, np.int64)
        self.seg_val2 = np.empty(self.seg_cap, np.int64)
        self.hole_pair = np.empty(self.hole_cap, np.int32)
        self.hole_aoff = np.empty(self.hole_cap, np.int64)
        self.hole_boff = np.empty(self.hole_cap, np.int64)
        self.hole_alen = np.empty(self.hole_cap, np.int32)
        self.hole_blen = np.empty(self.hole_cap, np.int32)
        self.hole_cls = np.empty(self.hole_cap, np.uint8)
        self.lit_buf = np.empty(self.lit_cap, np.uint8)

    def destroy(self, lib) -> None:
        try:
            lib.hsp_destroy(self.hf)
            lib.scratch_destroy(self.as_)
            lib.rank_scratch_destroy(self.rs)
            lib.engine_scratch_destroy(self.es)
        except Exception:
            pass


class _FastaWindows:
    """Bulk-parsed FASTA file: offset arrays over one byte buffer."""

    def __init__(self, path: str) -> None:
        from ..io.fastx import open_maybe_gz, _seq_delete_table
        lib = get_lib()
        with open_maybe_gz(path) as f:
            raw = f.read()
        self.buf = np.frombuffer(raw, dtype=np.uint8)
        n = len(self.buf)
        keep = np.ones(256, dtype=np.uint8)
        for c in _seq_delete_table(True):
            keep[c] = 0
        max_rec = max(n // 8, 1024)
        while True:
            seq_buf = np.empty(n if n else 1, dtype=np.uint8)
            seq_off = np.empty(max_rec + 1, dtype=np.int64)
            lbl_off = np.empty(max_rec, dtype=np.int64)
            lbl_end = np.empty(max_rec, dtype=np.int64)
            n_empty = np.zeros(1, dtype=np.int64)
            nrec = lib.fasta_parse_c(
                self.buf.ctypes.data, n, keep.ctypes.data,
                seq_buf.ctypes.data, len(seq_buf), seq_off.ctypes.data,
                lbl_off.ctypes.data, lbl_end.ctypes.data, max_rec,
                n_empty.ctypes.data)
            if nrec >= 0:
                break
            max_rec *= 4
        self.n = int(nrec)
        self.raw = raw
        self.seq_buf = seq_buf
        self.seq_off = seq_off[:self.n + 1]
        self.lbl_off = lbl_off[:self.n]
        self.lbl_end = lbl_end[:self.n]
        if int(n_empty[0]) and not options().flag("quiet"):
            import sys
            print(f"WARNING: {int(n_empty[0])} zero-length sequences "
                  "skipped", file=sys.stderr)
        self._raw = raw

    def label(self, i: int) -> str:
        from ..io.fastx import _proc_label
        return _proc_label(bytes(self.buf[self.lbl_off[i]:self.lbl_end[i]]))

    def seq(self, i: int) -> np.ndarray:
        return self.seq_buf[self.seq_off[i]:self.seq_off[i + 1]]


class BatchEngine:
    """Window-batched global search vs a fixed SeqDB."""

    # widest hole band the forward kernel takes
    # (ops/wavefront_nw.py:BW_MAX)
    BW_DEV_MAX = 2047

    def __init__(self, cmd: str, db: SeqDB,
                 index: Optional[UDBIndex] = None,
                 device=None,
                 card_factory: Optional[Callable] = None) -> None:
        o = options()
        self.lib = get_lib()
        self.db = db
        self.nucleo = db.get_is_nucleo()
        self.ap = AlnParams.from_cmdline(self.nucleo)
        self.ah = AlnHeuristics.from_cmdline(self.ap)
        self.index = index if index is not None else UDBIndex.from_seqdb(db)
        self.index._flatten()
        term = Terminator(cmd)
        self.max_accepts = term.max_accepts
        self.max_rejects = term.max_rejects
        self.K = self.max_accepts + self.max_rejects
        self.min_id = o.flt("id") if o.filled("id") else -1.0
        self.has_max_id = o.filled("maxid")
        self.max_id = o.flt("maxid") if self.has_max_id else 1.0
        self.full_dp_always = self.ah.full_dp_always
        self.fail_if_no_hsps = not o.flag("gaforce")
        self.bump = o.uns("bump")
        self.quicksort = o.flag("quicksort")

        from ..alpha import (CHAR_TO_COMP_CHAR, CHAR_TO_LETTER_AMINO,
                             CHAR_TO_LETTER_NUCLEO, IS_LOWER,
                             MATCH_MX_AMINO, MATCH_MX_NUCLEO, TO_UPPER)
        ap = self.ap
        self._sub_mx = np.ascontiguousarray(ap.subst_mx, dtype=np.float32)
        ctl = (CHAR_TO_LETTER_NUCLEO if ap.nucleo
               else CHAR_TO_LETTER_AMINO)
        self._ctl_aln = np.ascontiguousarray(ctl)
        rank_tbl = ctl.copy()
        rank_tbl[IS_LOWER] = 0xFF
        self._ctl_rank = np.ascontiguousarray(rank_tbl)
        self._match = np.ascontiguousarray(
            (MATCH_MX_NUCLEO if ap.nucleo else MATCH_MX_AMINO)
            .astype(np.uint8))
        self._to_upper = np.ascontiguousarray(TO_UPPER)
        self._comp = CHAR_TO_COMP_CHAR
        self._gp = GapParams.from_alnparams(ap)

        self._lock = threading.Lock()     # device/perf/stats guard
        self._scratches: List[_Scratch] = []
        self._sc = self._new_scratch()

        # db view
        seqs = db.seqs
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        offs = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        self._db_concat = (np.ascontiguousarray(np.concatenate(seqs))
                          if len(seqs) else np.zeros(1, np.uint8))
        self._db_off = offs
        self._db_len = lens

        # device hole alignment: the card passed (a torch.device: its
        # LocalCard), or the factory's when a window first wants it;
        # neither: the host C kernel only
        self.card = None if device is None else as_card(device)
        self._card_factory = card_factory
        self._factory_lock = threading.Lock()
        self._factory_thread = None
        self._factory_error: Optional[BaseException] = None
        self._class_fused = {}
        # holes of at least this many cells leave chain_batch_c for
        # _align_holes (the device, or the host C kernel when it has none)
        self.dev_min_cells = int(o.str("dev_min_cells")) \
            if o.filled("dev_min_cells") else 2048
        # batch dispatch gate: explicit -dev_batch_cells forces a static
        # threshold; default is the adaptive DevicePerfModel prediction
        self.dev_batch_min_cells = int(o.str("dev_batch_cells")) \
            if o.filled("dev_batch_cells") else None
        self.perf = None
        self._windows_left = 1
        # rank_device_jobs: jobs ranked by a rank_override (the card's CSR
        # ranker); rank_host_rerank_jobs: those of them it left to the host;
        # the stages' spans (<stage>_ns, <stage>_n: obs.span) and the
        # candidate loop's counts; a rank override adds its ranker's
        self.dev_stats = {"dispatches": 0, "device_cells": 0,
                          "host_cells": 0, "rank_device_jobs": 0,
                          "rank_host_rerank_jobs": 0,
                          "queries": 0, "pairs": 0}
        for k in STAGES:
            self.dev_stats[k + "_ns"] = self.dev_stats[k + "_n"] = 0
        # run_file's: whether torch.profiler records it, and its number
        self.trace = False
        self.seq = 0
        # adaptive gating on the card (in this process or the server's:
        # the factory's card); the CPU (the kernels' plain versions,
        # for tests) uses -dev_batch_cells
        if card_factory is not None or (self.card is not None
                                        and self.card.type == "cuda"):
            self.perf = DevicePerfModel("cuda")

    def _new_scratch(self) -> _Scratch:
        sc = _Scratch(self.lib, self.ah, self.ap.nucleo, self._sub_mx,
                      self._ctl_aln)
        if self.min_id >= 0.0:
            # arm UDBSearchBig semantics (stepped words, first-touch tie
            # order) for ranks above -big targets
            from ..config import options
            o = options()
            self.lib.rank_scratch_set_big(
                sc.rs, float(self.min_id), 1 if self.ap.nucleo else 0,
                o.uns("stepwords"), getattr(self.index, "db_step", 1),
                o.uns("big"))
        self._scratches.append(sc)
        return sc

    def __del__(self):
        for sc in getattr(self, "_scratches", ()):
            sc.destroy(self.lib)

    # -- one window ------------------------------------------------------
    def _rank_jobs(self, jbuf: np.ndarray, j_off: np.ndarray,
                   sc: Optional[_Scratch] = None):
        sc = sc or self._sc
        lib = self.lib
        ix = self.index
        p = ix.params
        n_jobs = len(j_off) - 1
        K = self.K
        cand = np.empty((n_jobs, K), np.uint32)
        cnts = np.empty((n_jobs, K), np.uint32)
        out_n = np.empty(n_jobs, np.int32)
        out_more = np.empty(n_jobs, np.uint8)
        has_csr = ix._postings is not None and len(ix._postings) > 0
        p16 = getattr(ix, "_postings16", None)
        csr_mode = 2 if (has_csr and p16 is not None) else int(has_csr)
        csr_post = p16 if csr_mode == 2 else ix._postings
        Z64 = np.zeros(1, np.int64)
        Z32 = np.zeros(1, np.int32)
        sw = ix._sorted_w if ix._sorted_w is not None else Z64
        st = ix._sorted_t if ix._sorted_t is not None else Z32
        n_sorted = len(sw) if ix._sorted_w is not None else 0
        if ix._pending_words:
            pw, pt = ix._pending_raw()
        else:
            pw, pt = Z64, Z32
        n_pending = len(pw) if ix._pending_words else 0
        # mode 0 = SetTopBump + count-sort, the rank() path (quicksort is
        # rejected by engine_eligible)
        lib.rank_batch_c(
            sc.rs, sc.es,
            jbuf.ctypes.data, j_off.ctypes.data, n_jobs,
            self._ctl_rank.ctypes.data, p.alpha_size, p.word_length,
            p.slot_count,
            ix._starts.ctypes.data if has_csr else None,
            csr_post.ctypes.data if has_csr else None, csr_mode,
            sw.ctypes.data, st.ctypes.data, n_sorted,
            pw.ctypes.data, pt.ctypes.data, n_pending,
            ix.seq_count, self.bump, 0, K,
            cand.ctypes.data, cnts.ctypes.data, out_n.ctypes.data,
            out_more.ctypes.data)
        sc.keep_alive = (sw, st, pw, pt)
        return cand, cnts, out_n

    def _chain_round(self, sc, jbuf, j_off, pair_j, pair_t):
        """chain_batch_c with capacity retry; returns packed plan."""
        lib = self.lib
        ah = self.ah
        n_pairs = len(pair_j)
        status = np.empty(n_pairs, np.uint8)
        pair_seg_off = np.empty(n_pairs + 1, np.int64)
        while True:
            n_hole = lib.chain_batch_c(
                sc.hf, sc.as_, sc.es,
                ctypes.byref(self._gp), self._sub_mx.ctypes.data,
                self._match.ctypes.data,
                ah.band_radius, ah.min_global_hsp_length,
                ah.min_global_hsp_fract_id, ah.min_global_hsp_score,
                ah.xdrop_global_hsp, int(self.full_dp_always),
                int(self.fail_if_no_hsps),
                jbuf.ctypes.data, j_off.ctypes.data,
                self._db_concat.ctypes.data, self._db_off.ctypes.data,
                self._db_len.ctypes.data,
                pair_j.ctypes.data, pair_t.ctypes.data, n_pairs,
                self.dev_min_cells,
                status.ctypes.data,
                sc.seg_kind.ctypes.data, sc.seg_val.ctypes.data,
                sc.seg_val2.ctypes.data, pair_seg_off.ctypes.data,
                sc.seg_cap,
                sc.hole_pair.ctypes.data, sc.hole_aoff.ctypes.data,
                sc.hole_boff.ctypes.data, sc.hole_alen.ctypes.data,
                sc.hole_blen.ctypes.data, sc.hole_cls.ctypes.data,
                sc.hole_cap,
                sc.lit_buf.ctypes.data, sc.lit_cap)
            if n_hole >= 0:
                return status, pair_seg_off, int(n_hole)
            if n_hole == -1:
                sc.seg_cap *= 4
            elif n_hole == -2:
                sc.hole_cap *= 4
            elif n_hole == -3:
                sc.lit_cap *= 4
            else:
                raise RuntimeError("chain_batch_c DP error")
            sc.alloc_round_bufs()

    def _align_holes(self, sc, jbuf, n_hole: int):
        """Align the round's holes: on the device per terminal class,
        in the host C kernel for bands wider than BW_DEV_MAX or when the
        gate says host.  Returns (hole_paths bytes, hole_off int64).

        Dispatch decision: adaptive cost model (DevicePerfModel) — device
        when the predicted dispatch time (rtt + transfer + compute,
        constants learned from measured dispatches) beats the host C
        kernel, with the first-dispatch tax spread over the windows still
        to come.  -dev_batch_cells forces a static threshold."""
        import time
        if n_hole == 0:
            return np.zeros(1, np.uint8), np.zeros(1, np.int64)
        cls = sc.hole_cls[:n_hole]
        aoff = sc.hole_aoff[:n_hole]
        boff = sc.hole_boff[:n_hole]
        alen = sc.hole_alen[:n_hole]
        blen = sc.hole_blen[:n_hole]
        r = self.ah.band_radius
        cells = np.minimum(alen, blen).astype(np.int64) * (2 * r + 1)
        total_cells = int(cells.sum())
        seq_len = alen.astype(np.int64) + blen
        up_bytes = int(seq_len.sum()) * 2      # padding estimate
        dn_bytes = int(seq_len.sum()) // 4 + 4 * n_hole
        dev_ok = np.abs(alen.astype(np.int64) - blen) + 2 * r + 1 \
            <= self.BW_DEV_MAX
        use_device = False
        # the device DP scores nucleotides only (scalar match/mismatch)
        if self.ap.nucleo and dev_ok.any() and (
                self.card is not None or self._card_factory is not None):
            if self.dev_batch_min_cells is not None:
                use_device = total_cells >= self.dev_batch_min_cells
            elif self.perf is not None:
                left = max(1, 2 * self._windows_left)
                use_device = self.perf.device_wins(total_cells, up_bytes,
                                                   dn_bytes, left)
                if (not use_device and not self.perf.warm
                        and self.perf.device_wins(total_cells, up_bytes,
                                                  dn_bytes, 1 << 30)):
                    # only the first dispatch's tax vetoes the device,
                    # which a warm server has paid: find out (the
                    # factory: a ping where a server is up)
                    self.ensure_card()
                    use_device = self.perf.warm and self.perf.device_wins(
                        total_cells, up_bytes, dn_bytes, left)
                use_device = use_device or self.perf.should_probe(
                    total_cells)
        if use_device:
            self.ensure_card()
        host = np.nonzero(~dev_ok if use_device else
                          np.ones(n_hole, bool))[0]
        paths: List[Optional[bytes]] = [None] * n_hole
        if len(host):
            t0 = time.perf_counter()
            out, off = self._align_holes_host(
                sc, jbuf, len(host), aoff[host], boff[host], alen[host],
                blen[host], cls[host])
            dt = time.perf_counter() - t0
            ob = out.tobytes()
            for k, h in enumerate(host):
                paths[h] = ob[off[k]:off[k + 1]]
            host_cells = int(cells[host].sum())
            with self._lock:
                if self.perf is not None:
                    self.perf.observe_host(host_cells, dt)
                self.dev_stats["host_cells"] += host_cells
        if use_device:
            db = self._db_concat
            dev_cells = int(cells[dev_ok].sum())
            # device dispatch serializes on the lock: host chains in
            # other threads keep running while one thread feeds the card
            with self._lock:
                t0 = time.perf_counter()
                for c in np.unique(cls[dev_ok]):
                    idx = np.nonzero((cls == c) & dev_ok)[0]
                    pairs = [(jbuf[aoff[h]:aoff[h] + alen[h]],
                              db[boff[h]:boff[h] + blen[h]]) for h in idx]
                    _scores, ps = self._class_fused_aligner(int(c)).align(
                        pairs, r, nucleo=True, stats=self.dev_stats,
                        trace=self.trace)
                    for k, h in enumerate(idx):
                        paths[h] = ps[k].encode("ascii")
                if self.perf is not None:
                    dev_seq = int(seq_len[dev_ok].sum())
                    self.perf.observe_dev(
                        dev_cells, 2 * dev_seq,
                        dev_seq // 4 + 4 * int(dev_ok.sum()),
                        time.perf_counter() - t0)
                self.dev_stats["dispatches"] += 1
                self.dev_stats["device_cells"] += dev_cells
        hole_off = np.zeros(n_hole + 1, np.int64)
        np.cumsum([len(p) for p in paths], out=hole_off[1:])
        return np.frombuffer(b"".join(paths), dtype=np.uint8), hole_off

    def _align_holes_host(self, sc, jbuf, n_hole, aoff, boff, alen, blen,
                          cls):
        """Host-kernel fallback for emitted holes (align_holes_c)."""
        lib = self.lib
        cap = int((alen.astype(np.int64) + blen).sum()) + 2 * n_hole + 16
        out = np.empty(cap, np.uint8)
        off = np.zeros(n_hole + 1, np.int64)
        aoff_c = np.ascontiguousarray(aoff, dtype=np.int64)
        boff_c = np.ascontiguousarray(boff, dtype=np.int64)
        alen_c = np.ascontiguousarray(alen, dtype=np.int32)
        blen_c = np.ascontiguousarray(blen, dtype=np.int32)
        cls_c = np.ascontiguousarray(cls, dtype=np.uint8)
        n = lib.align_holes_c(
            sc.es, ctypes.byref(self._gp), self._sub_mx.ctypes.data,
            self.ah.band_radius,
            jbuf.ctypes.data, self._db_concat.ctypes.data,
            aoff_c.ctypes.data, boff_c.ctypes.data, alen_c.ctypes.data,
            blen_c.ctypes.data, cls_c.ctypes.data, None, n_hole,
            out.ctypes.data, off.ctypes.data, cap)
        if n < 0:
            raise RuntimeError("align_holes_c failed")
        return out, off

    def _class_fused_aligner(self, cls_bits: int):
        """The card's aligner of a terminal-penalty class (terminal-gap
        penalties vary per hole position)."""
        fa = self._class_fused.get(cls_bits)
        if fa is None:
            fa = self._class_fused[cls_bits] = self.card.aligner(self.ap,
                                                                 cls_bits)
        return fa

    def _set_card(self, card) -> None:
        """Take the factory's card; a warm one's first dispatch pays no
        tax."""
        if card.warm:
            self.perf.warm = True
        self.card = card

    def ensure_card(self):
        """The card, from the factory if it has none yet: the factory
        runs once, here or in the warm-up thread, whose exception this
        raises.  None without card and factory."""
        th = self._factory_thread
        if th is not None:
            th.join()
        with self._factory_lock:
            if self._factory_error is not None:
                raise self._factory_error
            if self.card is None and self._card_factory is not None:
                self._set_card(self._card_factory())
        return self.card

    def _ensure_card_async(self) -> None:
        """Run the factory in a thread (the server's ping or spawn, or
        torch's import and the CUDA start) beside the host's parse, rank
        and chain stages, which release the GIL; ensure_card() joins
        it."""
        with self._factory_lock:
            if (self.card is not None or self._card_factory is None
                    or self._factory_thread is not None):
                return

            def work():
                try:
                    card = self._card_factory()
                except BaseException as e:  # noqa: BLE001 - to the command
                    self._factory_error = e
                    return
                with self._factory_lock:
                    self._set_card(card)

            self._factory_thread = threading.Thread(target=work, daemon=True)
            self._factory_thread.start()

    def _finish_round(self, sc, jbuf, j_off, pair_j, pair_t, status,
                      pair_seg_off, hole_paths, hole_off, job_state):
        lib = self.lib
        n_pairs = len(pair_j)
        max_hits = n_pairs + 1
        while True:
            # finish_replay_c mutates job_state/out_used as it replays, so
            # capacity retries must run on a fresh copy and commit at the
            # end
            job_state_try = job_state.copy()
            out_used = np.zeros(len(j_off) - 1, np.int32)
            hit_job = np.empty(max_hits, np.int32)
            hit_tix = np.empty(max_hits, np.uint32)
            hit_paths = np.empty(sc.hitpath_cap, np.uint8)
            hit_path_off = np.empty(max_hits + 1, np.int64)
            hit_stats = np.empty((max_hits, 10), np.int64)
            n_hits = lib.finish_replay_c(
                sc.es,
                status.ctypes.data,
                sc.seg_kind.ctypes.data, sc.seg_val.ctypes.data,
                sc.seg_val2.ctypes.data, pair_seg_off.ctypes.data,
                pair_j.ctypes.data, pair_t.ctypes.data, n_pairs,
                sc.lit_buf.ctypes.data,
                hole_paths.ctypes.data, hole_off.ctypes.data,
                jbuf.ctypes.data, j_off.ctypes.data,
                self._db_concat.ctypes.data, self._db_off.ctypes.data,
                self._db_len.ctypes.data,
                self._match.ctypes.data, self._to_upper.ctypes.data,
                self.min_id, self.max_id, int(self.has_max_id),
                self.max_accepts, self.max_rejects,
                job_state_try.ctypes.data, out_used.ctypes.data,
                hit_job.ctypes.data, hit_tix.ctypes.data,
                hit_paths.ctypes.data, hit_path_off.ctypes.data,
                sc.hitpath_cap, hit_stats.ctypes.data, max_hits)
            if n_hits >= 0:
                break
            sc.hitpath_cap *= 4
        job_state[:] = job_state_try
        return (hit_job[:n_hits], hit_tix[:n_hits], hit_paths,
                hit_path_off[:n_hits + 1], hit_stats[:n_hits], out_used)

    def search_window(self, jbuf: np.ndarray, j_off: np.ndarray,
                      collect_hits: Callable,
                      rank_override: Optional[Callable] = None,
                      collect_round: Optional[Callable] = None,
                      sc: Optional[_Scratch] = None) -> None:
        """Run all jobs to termination.  collect_hits(j, tix, path_bytes,
        stats_row) is called per accepted hit in acceptance order.
        collect_round, when given, replaces the per-hit loop: it is
        called once per candidate round with the round's packed arrays
        (hit_job, hit_tix, hit_paths, hit_path_off, hit_stats) — hits
        stable-sorted by job across rounds reproduce acceptance order.
        rank_override(jbuf, j_off) -> (cand, cnts, out_n) substitutes the
        ranking stage (ops/csr_rank.py's ranker on the card)."""
        sc = sc or self._sc
        n_jobs = len(j_off) - 1
        # this window's counts, added to dev_stats at its end (windows
        # run on threads)
        st = {}
        tr, seq = self.trace, self.seq
        with obs.span(st, "rank", tr, seq):
            if rank_override is not None:
                cand, cnts, out_n = rank_override(jbuf, j_off)
                st["rank_device_jobs"] = n_jobs
            else:
                cand, cnts, out_n = self._rank_jobs(jbuf, j_off, sc)
        job_state = np.zeros((n_jobs, 3), np.int32)
        ptr = np.zeros(n_jobs, np.int32)
        depth = 1
        while True:
            live = np.nonzero((job_state[:, 2] == 0) & (ptr < out_n))[0]
            if len(live) == 0:
                break
            with obs.span(st, "round", tr, seq):
                take = np.minimum(out_n[live] - ptr[live], depth)
                pair_j = np.repeat(live, take).astype(np.int32)
                # candidate indexes ptr[j] .. ptr[j]+take-1 per job
                csum = np.concatenate(([0], np.cumsum(take)))
                within = np.arange(csum[-1]) - np.repeat(csum[:-1], take)
                pair_k = np.repeat(ptr[live], take) + within
                pair_t = np.ascontiguousarray(cand[pair_j, pair_k])
                obs.add(st, "pairs", len(pair_j))
                with obs.span(st, "chain", tr, seq):
                    status, pair_seg_off, n_hole = self._chain_round(
                        sc, jbuf, j_off, pair_j, pair_t)
                if n_hole:
                    with obs.span(st, "holes", tr, seq):
                        hole_paths, hole_off = self._align_holes(sc, jbuf,
                                                                 n_hole)
                else:
                    hole_paths, hole_off = self._align_holes(sc, jbuf, 0)
                with obs.span(st, "replay", tr, seq):
                    (hit_job, hit_tix, hit_paths, hit_path_off, hit_stats,
                     out_used) = self._finish_round(
                        sc, jbuf, j_off, pair_j, pair_t, status, pair_seg_off,
                        hole_paths, hole_off, job_state)
                ptr[live] += take
                if collect_round is not None:
                    if len(hit_job):
                        collect_round(hit_job, hit_tix, hit_paths,
                                      hit_path_off, hit_stats)
                elif len(hit_job):
                    jobs_l = hit_job.tolist()
                    tix_l = hit_tix.tolist()
                    offs_l = hit_path_off.tolist()
                    stats_l = hit_stats.tolist()   # python ints: cheap emit
                    pb = hit_paths[:offs_l[-1]].tobytes()
                    for k in range(len(jobs_l)):
                        collect_hits(jobs_l[k], tix_l[k],
                                     pb[offs_l[k]:offs_l[k + 1]], stats_l[k])
                if self.card is not None:
                    depth = min(depth * 2, 8)   # fewer device round trips
                # no device: depth stays 1 (zero speculation waste)
        with self._lock:
            obs.merge(self.dev_stats, st)

    # -- file driver -----------------------------------------------------
    def run_file(self, query_path: str, on_query_done: Callable,
                 window: int = 8192, fast_emit=None,
                 rank_override: Optional[Callable] = None,
                 records: Optional[Tuple[int, int]] = None) -> None:
        """Stream the query file through the engine.  on_query_done(label,
        seq, hits) per record in input order (hits = AlignResult list in
        acceptance order, fwd strand first — identical to the serial
        driver).  fast_emit, when given, is called as
        fast_emit(win, rec_lo, rec_hi, per_rec_hits) instead of building
        AlignResult objects.  rank_override: see search_window; the
        windows then run one after another.  records: the (lo, hi) range
        of the file's records to search (default: all).

        The call's stages add their spans to dev_stats (STAGES), and
        with queries (records searched) and pairs (candidate pairs
        chained) the USEARCH_DEVICE_STATS line carries them."""
        from .. import runlog
        self.seq += 1
        self.trace = tr = obs.profiling()
        st = {}
        with obs.span(st, "request", tr, self.seq):
            n = self._search_file(st, query_path, on_query_done, window,
                                  fast_emit, rank_override, records)
            with obs.span(st, "save", tr, self.seq):
                runlog.note_index(self.index)
                ds = self.dev_stats
                runlog.note(
                    f"Search: {n} queries, window {window}, "
                    f"device {'on' if self.card is not None else 'off'}"
                    f" ({ds['dispatches']} dispatches, "
                    f"{ds['device_cells']} device cells, "
                    f"{ds['host_cells']} host cells)")
                if self.perf is not None:
                    self.perf.save()
        with self._lock:
            obs.merge(self.dev_stats, st)
        stats_path = os.environ.get("USEARCH_DEVICE_STATS")
        if stats_path:
            import json
            with open(stats_path, "a") as f:
                f.write(json.dumps({
                    "device": self.card is not None,
                    "server": self.card is not None and self.card.remote,
                    **self.dev_stats,
                    "host_rate": None if self.perf is None
                    else round(self.perf.host_rate),
                    "dev_rate": None if self.perf is None
                    else round(self.perf.dev_rate)}) + "\n")

    def _search_file(self, st, query_path, on_query_done, window, fast_emit,
                     rank_override, records) -> int:
        """run_file's search, its spans and counts in st; returns the
        file's record count."""
        tr, seq = self.trace, self.seq
        o = options()
        strand_both = False
        if self.nucleo:
            if not o.filled("strand"):
                raise SystemExit(
                    "Must specify -strand plus or both with nt db")
            s = o.str("strand")
            if s == "both":
                strand_both = True
            elif s != "plus":
                raise SystemExit("Invalid -strand, must be plus or both")
        with obs.span(st, "parse", tr, seq):
            win = _FastaWindows(query_path)
        n = win.n
        # long sequences are the hole DP's workload: the factory's card
        # starts now, beside the host stages, not at the first dispatch
        if n and self.card is None and self._card_factory is not None \
                and int(np.diff(win.seq_off).max()) >= 2000:
            self._ensure_card_async()
        progress.start("Searching")
        db = self.db
        # fast label decode (slow _proc_label only when options demand)
        trunclabels = o.flag("trunclabels")
        truncstr = o.str("truncstr") if o.filled("truncstr") else None
        # packed C emit path: raw labels go straight to the C formatter
        packed_em = getattr(fast_emit, "emit_packed", None)
        if packed_em is not None and (trunclabels or truncstr is not None):
            packed_em = None
        if packed_em is None and fast_emit is not None \
                and not callable(fast_emit):
            fast_emit = fast_emit.emit
        raw_bytes = win.raw            # bytes slicing beats np round-trip
        lbl_off = win.lbl_off.tolist()
        lbl_end = win.lbl_end.tolist()

        def label_of(i):
            raw = raw_bytes[lbl_off[i]:lbl_end[i]]
            if trunclabels or truncstr is not None:
                from ..io.fastx import _proc_label
                return _proc_label(raw)
            return raw.decode("latin1")

        r_lo, r_hi = records if records is not None else (0, n)
        obs.add(st, "queries", r_hi - r_lo)
        n_windows = max(1, (r_hi - r_lo + window - 1) // window)
        soff = win.seq_off

        def build_window(lo, hi):
            nrec = hi - lo
            if strand_both:
                parts = []
                for r in range(lo, hi):
                    s = win.seq_buf[soff[r]:soff[r + 1]]
                    parts.append(s)
                    parts.append(self._comp[s][::-1])
                jbuf = (np.concatenate(parts) if parts
                        else np.zeros(1, np.uint8))
                lens = np.repeat(soff[lo + 1:hi + 1] - soff[lo:hi], 2)
                j_off = np.zeros(2 * nrec + 1, np.int64)
                np.cumsum(lens, out=j_off[1:])
                return jbuf, j_off, 2
            jbuf = np.ascontiguousarray(win.seq_buf[soff[lo]:soff[hi]])
            j_off = (soff[lo:hi + 1] - soff[lo]).astype(np.int64)
            return jbuf, j_off, 1

        def compute_window(lo, hi, sc):
            """All C/DP work for one window — thread-safe given a
            thread-private scratch; emission happens separately so
            output order stays deterministic under any thread count."""
            wst = {}
            with obs.span(wst, "parse", tr, seq):
                jbuf, j_off, jobs_per_rec = build_window(lo, hi)
            with self._lock:
                obs.merge(self.dev_stats, wst)
            if packed_em is not None:
                rounds = []

                def collect_round(hj, ht, hp, hpo, hs):
                    rounds.append((hj.copy(), ht.copy(), hs.copy()))

                self.search_window(jbuf, j_off, None,
                                   rank_override=rank_override,
                                   collect_round=collect_round, sc=sc)
                return (jbuf, j_off, jobs_per_rec, rounds, None)
            per_job_hits: List[List] = [[] for _ in range(
                (hi - lo) * jobs_per_rec)]

            def collect(j, tix, path_b, stats):
                per_job_hits[j].append((tix, path_b, stats))

            self.search_window(jbuf, j_off, collect,
                               rank_override=rank_override, sc=sc)
            return (jbuf, j_off, jobs_per_rec, None, per_job_hits)

        def emit_window(lo, hi, res):
            jbuf, j_off, jobs_per_rec, rounds, per_job_hits = res
            nrec = hi - lo
            if rounds is not None:
                n_jobs = nrec * jobs_per_rec
                if rounds:
                    hj = np.concatenate([x[0] for x in rounds])
                    ht = np.concatenate([x[1] for x in rounds])
                    hs = np.vstack([x[2] for x in rounds])
                    order = np.argsort(hj, kind="stable")
                    hj, ht, hs = hj[order], ht[order], hs[order]
                else:
                    hj = np.zeros(0, np.int32)
                    ht = np.zeros(0, np.uint32)
                    hs = np.zeros((0, 10), np.int64)
                job_start = np.searchsorted(
                    hj, np.arange(n_jobs + 1)).astype(np.int64)
                packed_em(win.buf, win.lbl_off[lo:hi], win.lbl_end[lo:hi],
                          jobs_per_rec, j_off, hj, ht, hs, job_start)
            elif fast_emit is not None:
                fast_emit(label_of, lo, hi, per_job_hits, jobs_per_rec,
                          j_off, jbuf)
            else:
                for r in range(nrec):
                    label = label_of(lo + r)
                    seq = win.seq(lo + r)
                    hits = []
                    for s in range(jobs_per_rec):
                        j = r * jobs_per_rec + s
                        is_rc = s == 1
                        qseq = (jbuf[j_off[j]:j_off[j + 1]] if is_rc
                                else seq)
                        for tix, path_b, stats in per_job_hits[j]:
                            hits.append(self._make_ar(
                                label, qseq, int(tix),
                                path_b.decode("ascii"), stats, is_rc))
                    on_query_done(label, seq, hits)
            progress.tick(hi, n)

        bounds = [(lo, min(lo + window, r_hi))
                  for lo in range(r_lo, r_hi, window)]
        n_threads = _thread_count()
        if n_threads > 1 and len(bounds) > 1 and rank_override is None:
            # per-thread scratch; ex.map preserves window order, so the
            # emitted bytes are identical to the serial path
            import concurrent.futures as cf
            tl = threading.local()

            def work(b):
                sc = getattr(tl, "sc", None)
                if sc is None:
                    with self._lock:
                        sc = self._new_scratch()
                    tl.sc = sc
                return compute_window(b[0], b[1], sc)

            self._windows_left = n_windows
            with cf.ThreadPoolExecutor(max_workers=n_threads) as ex:
                for (lo, hi), res in zip(bounds, ex.map(work, bounds)):
                    with obs.span(st, "emit", tr, seq):
                        emit_window(lo, hi, res)
        else:
            for wi, (lo, hi) in enumerate(bounds):
                self._windows_left = n_windows - wi
                res = compute_window(lo, hi, self._sc)
                with obs.span(st, "emit", tr, seq):
                    emit_window(lo, hi, res)
        progress.done(f"{n} queries")
        if self._factory_thread is not None:
            self._factory_thread.join()
        return n

    def _make_ar(self, label, qseq, tix, path, stats, is_rc):
        db = self.db
        ar = AlignResult(query_label=label, target_label=db.labels[tix],
                         query_seq=qseq, target_seq=db.seqs[tix],
                         path=path, nucleo=self.nucleo, target_index=tix,
                         query_revcomp=is_rc)
        (first_m, last_m, ar.first_m_qpos, ar.first_m_tpos,
         ar.last_m_qpos, ar.last_m_tpos, id_count, diff_a, m_cols,
         gap_opens) = (int(v) for v in stats)
        ar.id_count = id_count
        ar.mismatch_count = m_cols - id_count
        ar.diff_count_a = diff_a
        ar.first_m_col = first_m
        ar.last_m_col = last_m
        ar.aln_length = last_m - first_m + 1
        ar.int_gap_count = ar.aln_length - m_cols
        ar.term_gap_count = len(path) - ar.aln_length
        ar._gap_opens = gap_opens
        ar._filled = True
        return ar
