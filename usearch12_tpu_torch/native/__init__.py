"""ctypes bindings to the native host kernels (usearch_native.c).

The shared library is compiled on first use with gcc -O3 into
build/usearch12_tpu_torch/native/ at the root of the checkout (keyed by
source mtime), apart from any other build of the same sources.  Each
build writes a file of its own and renames it into place, so processes
that build at the same time never load a half-written library.  Falls
back to the pure-Python oracle when a compiler is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "usearch_native.c")
_SRC2 = os.path.join(_DIR, "usearch_engine.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "usearch12_tpu_torch", "native")
_SO = os.path.join(BUILD_DIR, "_usearch_native.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


class GapParams(ctypes.Structure):
    _fields_ = [
        ("open_a", ctypes.c_float), ("open_b", ctypes.c_float),
        ("ext_a", ctypes.c_float), ("ext_b", ctypes.c_float),
        ("l_open_a", ctypes.c_float), ("l_open_b", ctypes.c_float),
        ("r_open_a", ctypes.c_float), ("r_open_b", ctypes.c_float),
        ("l_ext_a", ctypes.c_float), ("l_ext_b", ctypes.c_float),
        ("r_ext_a", ctypes.c_float), ("r_ext_b", ctypes.c_float),
    ]

    @classmethod
    def from_alnparams(cls, ap) -> "GapParams":
        return cls(ap.open_a, ap.open_b, ap.ext_a, ap.ext_b,
                   ap.l_open_a, ap.l_open_b, ap.r_open_a, ap.r_open_b,
                   ap.l_ext_a, ap.l_ext_b, ap.r_ext_a, ap.r_ext_b)


def _build() -> Optional[str]:
    src_mtime = max(os.path.getmtime(_SRC), os.path.getmtime(_SRC2))
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= src_mtime:
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    # -O3 -march=native for throughput; -ffp-contract=off keeps the DP
    # float-op DAG bit-identical to the device kernels and the reference
    # (no FMA contraction of a*b+c)
    # -Werror=implicit-function-declaration: an undeclared extern would
    # promote float args to double at the call site and silently corrupt
    # DP parameters
    for flags in (["-O3", "-march=native", "-ffp-contract=off"],
                  ["-O2"]):
        try:
            subprocess.run(
                ["gcc", *flags, "-Werror=implicit-function-declaration",
                 "-shared", "-fPIC", "-o", tmp, _SRC, _SRC2],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
            return _SO
        except Exception:
            continue
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return None


def get_lib():
    """Returns the loaded ctypes library or None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(so)
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C")
        f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C")
        lib.nw_band.restype = ctypes.c_int
        lib.nw_band.argtypes = [
            u8p, ctypes.c_uint32, u8p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.POINTER(GapParams),
            f32p, u8p, f32p, f32p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float)]
        lib.nw_full.restype = ctypes.c_int
        lib.nw_full.argtypes = [
            u8p, ctypes.c_uint32, u8p, ctypes.c_uint32,
            ctypes.POINTER(GapParams), f32p, u8p, f32p, f32p,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
        lib.hsp_create.restype = ctypes.c_void_p
        lib.hsp_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32, f32p, u8p]
        lib.hsp_destroy.argtypes = [ctypes.c_void_p]
        lib.hsp_set_a.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32]
        lib.hsp_set_b.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32]
        lib.scratch_create.restype = ctypes.c_void_p
        lib.scratch_destroy.argtypes = [ctypes.c_void_p]
        u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C")
        lib.global_chain_c.restype = ctypes.c_int
        lib.global_chain_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, u8p,
            ctypes.c_uint32, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, u32p,
            ctypes.POINTER(ctypes.c_float)]
        lib.global_align_c.restype = ctypes.c_int
        lib.global_align_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(GapParams),
            u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
        lib.search_ranked_c.restype = ctypes.c_int64
        lib.search_ranked_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(GapParams),
            ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_int64]
        lib.fast_mask_c.restype = None
        lib.fast_mask_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint8]
        lib.path_stats_c.restype = ctypes.c_int
        lib.path_stats_c.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.dust_mask_c.restype = None
        lib.dust_mask_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        lib.unique_words_c.restype = ctypes.c_int64
        lib.unique_words_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_int64, ctypes.c_void_p]
        lib.rank_scratch_create.restype = ctypes.c_void_p
        lib.rank_scratch_destroy.argtypes = [ctypes.c_void_p]
        lib.rank_scratch_set_big.restype = None
        lib.rank_scratch_set_big.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
        lib.usort_rank_c.restype = ctypes.c_int64
        lib.usort_rank_c.argtypes = [
            ctypes.c_void_p,                          # scratch
            ctypes.c_void_p, ctypes.c_uint32,         # seq, L
            ctypes.c_void_p,                          # char_to_letter
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # CSR
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # sorted tier
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # pending tier
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int64,                           # max_emit (0 = all)
            ctypes.c_void_p, ctypes.c_void_p]         # out_tix, out_counts
        # -- batch engine (usearch_engine.c) --
        vp = ctypes.c_void_p
        i64 = ctypes.c_int64
        lib.engine_scratch_create.restype = vp
        lib.engine_scratch_destroy.argtypes = [vp]
        lib.fasta_parse_c.restype = i64
        lib.fasta_parse_c.argtypes = [vp, i64, vp, vp, i64, vp, vp, vp,
                                      i64, vp]
        lib.fast_mask_batch_c.restype = None
        lib.fast_mask_batch_c.argtypes = [vp, vp, i64, ctypes.c_int,
                                          ctypes.c_uint8]
        lib.rank_batch_c.restype = i64
        lib.rank_batch_c.argtypes = [
            vp, vp, vp, vp, i64,                  # scratches, jbuf, j_off, n
            vp, ctypes.c_uint32, ctypes.c_uint32, i64,   # table, alpha, w, slots
            vp, vp, ctypes.c_int,                 # CSR
            vp, vp, i64,                          # sorted tier
            vp, vp, i64,                          # pending tier
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, i64,
            vp, vp, vp, vp]                       # out tix/counts/n/more
        lib.chain_batch_c.restype = i64
        lib.chain_batch_c.argtypes = [
            vp, vp, vp,                           # hf, align scratch, eng
            ctypes.POINTER(GapParams), vp, vp,    # gp, sub_mx, match_mx
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            vp, vp,                               # jbuf, j_off
            vp, vp, vp,                           # db, db_off, db_len
            vp, vp, i64,                          # pair_j, pair_t, n_pairs
            i64,                                  # dev_min_cells
            vp,                                   # status
            vp, vp, vp, vp, i64,                  # segs
            vp, vp, vp, vp, vp, vp, i64,          # holes
            vp, i64]                              # lit buf
        lib.blast6_emit_c.restype = i64
        lib.blast6_emit_c.argtypes = [
            vp, vp, vp, i64, ctypes.c_int32, vp,   # raw, loff, lend, nrec, jpr, j_off
            vp, vp, vp, vp,                        # hit_job, tix, stats, job_start
            vp, vp, vp, ctypes.c_int32,            # tlbl buf/off, tlen, no_hits
            vp, i64]                               # out, cap
        lib.quick_sort_order_c.restype = None
        lib.quick_sort_order_c.argtypes = [vp, i64, ctypes.c_int, vp]
        lib.uniques_fasta_emit_c.restype = i64
        lib.uniques_fasta_emit_c.argtypes = [
            vp, vp, vp, i64, vp, i64, vp, vp, vp, vp,
            ctypes.c_int32, i64, vp, i64]
        lib.orient_batch_c.restype = None
        lib.orient_batch_c.argtypes = [
            vp, vp, i64, vp, vp, i64, i64, vp,
            ctypes.c_double, vp, vp]
        lib.orient_fasta_emit_c.restype = i64
        lib.orient_fasta_emit_c.argtypes = [
            vp, vp, vp, vp, vp, i64, vp, vp,
            ctypes.c_int32, i64, vp, i64]
        lib.sizes_from_labels_c.restype = None
        lib.sizes_from_labels_c.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.cluster_uc_emit_c.restype = i64
        lib.cluster_uc_emit_c.argtypes = [
            i64, vp,                               # n, order
            vp, vp, vp,                            # ulab buf/off, ulen
            vp, vp,                                # assign, hit_off
            vp, vp, vp,                            # hit tix/rc/pct
            vp, vp,                                # cpath off/buf
            vp,                                    # centroid_ui
            vp, vp,                                # memb off/idx
            vp, vp,                                # ilab buf/off
            ctypes.c_int32, vp, i64]               # nucleo, out, cap
        lib.uchime_left_right_c.restype = ctypes.c_int
        lib.uchime_left_right_c.argtypes = [
            vp, vp, ctypes.c_char_p, i64, vp, i64, vp]
        lib.uchime_parse_lo_c.restype = i64
        lib.uchime_parse_lo_c.argtypes = [
            vp, vp, ctypes.POINTER(GapParams), vp,
            i64, i64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            vp, i64, vp, vp, i64, vp, i64, vp, vp]
        lib.sintax_boots_c.restype = i64
        lib.sintax_boots_c.argtypes = [
            vp, vp, i64, vp, vp, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint32, vp,
            vp, vp, vp, vp, vp, vp]
        lib.sintax_grand_draws_c.restype = None
        lib.sintax_grand_draws_c.argtypes = [vp, vp, i64]
        lib.sintax_tally_window_c.restype = i64
        lib.sintax_tally_window_c.argtypes = [
            vp, vp, ctypes.c_int,                  # winners, tops, boots
            vp, i64, ctypes.c_int,                 # job map, n_q, both
            vp,                                    # tax ids
            vp, vp, vp, vp, vp]           # ntax, ids, cnts, twc, strand
        lib.ee_sum_c.restype = ctypes.c_double
        lib.ee_sum_c.argtypes = [ctypes.c_char_p, i64, vp]
        lib.merge_pair_c.restype = i64
        lib.merge_pair_c.argtypes = [
            vp, vp,
            vp, i64, ctypes.c_char_p,
            vp, i64, ctypes.c_char_p,
            vp,
            ctypes.c_double, i64, ctypes.c_double,
            i64, i64, i64, ctypes.c_double,
            i64, i64, i64, i64,
            vp, vp,
            vp, vp, vp]
        lib.merge_files_c.restype = i64
        lib.merge_files_c.argtypes = [
            vp, vp,
            ctypes.c_char_p, i64, ctypes.c_char_p, i64,
            vp, vp,
            ctypes.c_double, i64, ctypes.c_double,
            i64, i64, i64, ctypes.c_double,
            i64, i64, i64,
            i64, i64, i64,
            i64, i64,
            ctypes.c_char_p, i64,
            vp, vp,
            vp, i64, vp,
            i64,
            vp, vp, vp]
        lib.filter_files_c.restype = i64
        lib.filter_files_c.argtypes = [
            ctypes.c_char_p, i64,
            i64,
            i64, i64, i64,
            i64, i64, i64,
            i64, i64, i64,
            ctypes.c_double, ctypes.c_double, vp,
            i64,
            ctypes.c_char_p, i64,
            i64,
            vp, i64, vp,
            vp, i64, vp,
            vp, i64, vp,
            vp, i64, vp]
        lib.orient_read_c.restype = ctypes.c_int
        lib.orient_read_c.argtypes = [
            vp, i64, vp, vp, i64, i64, vp, ctypes.c_double, vp]
        lib.uparse_dp_c.restype = ctypes.c_int
        lib.uparse_dp_c.argtypes = [
            vp, i64, i64, vp, vp,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            vp, vp, vp]
        lib.join_files_c.restype = i64
        lib.join_files_c.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_char_p, i64,
            vp,
            ctypes.c_char_p, i64, ctypes.c_char_p, i64,
            i64, i64,
            i64, i64,
            i64, ctypes.c_char_p, i64,
            i64,
            vp, i64, vp,
            vp, i64, vp]
        lib.derep_c.restype = i64
        lib.derep_c.argtypes = [vp, vp, i64, vp, vp]
        lib.unoise_greedy_c.restype = i64
        lib.unoise_greedy_c.argtypes = [
            vp, vp, vp, vp, ctypes.POINTER(GapParams), vp,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
            vp, ctypes.c_uint32, ctypes.c_uint32, i64, ctypes.c_uint32,
            ctypes.c_double, ctypes.c_int32,
            vp, vp, i64, vp,
            vp, vp]
        lib.truncate_files_c.restype = i64
        lib.truncate_files_c.argtypes = [
            ctypes.c_char_p, i64,
            i64, i64,
            i64, ctypes.c_uint8,
            i64, i64, i64,
            i64,
            i64, ctypes.c_char_p, i64,
            i64,
            vp, i64, vp,
            vp, i64, vp]
        lib.filter2_files_c.restype = i64
        lib.filter2_files_c.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_char_p, i64,
            ctypes.c_double, vp,
            vp, i64, vp, vp, i64, vp]
        lib.sintax_window_c.restype = i64
        lib.sintax_window_c.argtypes = [
            vp,
            vp, vp, i64,
            vp, ctypes.c_int,
            vp, ctypes.c_uint32, ctypes.c_uint32, i64,
            vp, vp, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint32, vp,
            vp,
            vp, vp, vp, vp, vp]
        lib.local_multi_c.restype = i64
        lib.local_multi_c.argtypes = [
            vp, vp,
            vp, i64, vp, i64,
            vp, vp, i64,
            vp, i64, i64,
            vp,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double,
            i64,
            vp, vp,
            vp, i64, vp]
        lib.local_setq_c.restype = i64
        lib.local_setq_c.argtypes = [vp, i64, vp, i64, i64, vp, vp]
        lib.local_query_c.restype = i64
        lib.local_query_c.argtypes = [
            vp, vp,
            vp, i64,
            vp, vp,
            vp, i64,
            vp, i64, i64,
            vp, vp,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, i64, ctypes.c_double, i64,
            ctypes.c_int32, ctypes.c_int32,
            i64,
            vp, vp, vp,
            vp, i64, vp]
        lib.align_holes_c.restype = i64
        lib.align_holes_c.argtypes = [
            vp, ctypes.POINTER(GapParams), vp, ctypes.c_uint32,
            vp, vp,                               # jbuf, db
            vp, vp, vp, vp, vp, vp, i64,          # hole arrays
            vp, vp, i64]                          # out buf/off/cap
        lib.finish_replay_c.restype = i64
        lib.finish_replay_c.argtypes = [
            vp,                                   # eng scratch
            vp, vp, vp, vp, vp,                   # status, segs
            vp, vp, i64,                          # pair_j, pair_t, n
            vp, vp, vp,                           # lit, hole_paths, hole_off
            vp, vp,                               # jbuf, j_off
            vp, vp, vp,                           # db
            vp, vp,                               # id_mx, to_upper
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32,
            vp, vp,                               # job_state, out_used
            vp, vp, vp, vp, i64, vp, i64]         # hits
        lib.cluster_ctx_create.restype = vp
        lib.cluster_ctx_destroy.argtypes = [vp]
        lib.cluster_ctx_db_n.restype = i64
        lib.cluster_ctx_db_n.argtypes = [vp]
        lib.cluster_greedy_c.restype = i64
        lib.cluster_greedy_c.argtypes = [
            vp, vp, vp, vp,                       # cc, hf, as, es
            ctypes.POINTER(GapParams), vp, vp, vp, vp,  # gp, sub, match, id, upper
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            vp, ctypes.c_uint32, ctypes.c_uint32, i64,  # ctl, alpha, w, slots
            ctypes.c_uint32,                      # bump
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32,
            vp, vp, ctypes.c_int, i64, i64,       # qbuf, q_off, both, n, start
            vp, vp, vp,                           # assign, admit, hit_off
            vp, vp, vp, vp,                       # tix, rc, pct, fract
            vp, vp, i64, i64,                     # cpath_off, buf, cap, max
            vp]                                   # counters
        _lib = lib
        return _lib


class NativeRanker:
    """Native USORT candidate ranking (usort_rank_c): query word
    extraction + SetU over the LSM posting tiers + SetTopBump +
    CountSortOrderDesc in one C call.  Exact counterpart of
    search/usorted.py's host path (usearch12 src/udbusortedsearcher.cpp)."""

    def __init__(self, index) -> None:
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self.lib = lib
        self.index = index
        from ..alpha import (CHAR_TO_LETTER_AMINO, CHAR_TO_LETTER_NUCLEO,
                             IS_LOWER)
        p = index.params
        table = (CHAR_TO_LETTER_NUCLEO if p.is_nucleo
                 else CHAR_TO_LETTER_AMINO).copy()
        table[IS_LOWER] = 0xFF    # masked (lowercase) letters are bad
        self._table = np.ascontiguousarray(table)
        self._scratch = lib.rank_scratch_create()
        # arm big-DB mode (src/udbusortedsearcher.cpp:41-57): above
        # -big targets, mode-0 ranks switch to UDBSearchBig semantics
        # (stepped query words, first-touch tie order, no bump)
        try:
            from ..config import options
            o = options()
            if o.filled("id"):
                lib.rank_scratch_set_big(
                    self._scratch, float(o.flt("id")),
                    1 if p.is_nucleo else 0, o.uns("stepwords"),
                    getattr(index, "db_step", 1), o.uns("big"))
        except Exception:
            pass
        self._out_tix = np.zeros(0, dtype=np.uint32)
        self._out_counts = np.zeros(0, dtype=np.uint32)
        self._ZI64 = np.zeros(0, dtype=np.int64)
        self._ZI32 = np.zeros(0, dtype=np.int32)

    def __del__(self):
        try:
            self.lib.rank_scratch_destroy(self._scratch)
        except Exception:
            pass

    def _db_args(self, seq_count: int):
        """Cache the DB-view argument tuple; it only changes when the
        index's posting tiers or seq_count change."""
        ix = self.index
        key = (id(ix._postings), id(ix._sorted_w), ix._pending_total,
               seq_count)
        cached = getattr(self, "_db_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        if len(self._out_tix) < seq_count:
            cap = 2 * seq_count + 1024
            self._out_tix = np.zeros(cap, dtype=np.uint32)
            self._out_counts = np.zeros(cap, dtype=np.uint32)
        has_csr = ix._postings is not None and len(ix._postings) > 0
        p16 = getattr(ix, "_postings16", None)
        csr_mode = 2 if (has_csr and p16 is not None) else int(has_csr)
        csr_post = p16 if csr_mode == 2 else ix._postings
        sw = ix._sorted_w if ix._sorted_w is not None else self._ZI64
        st = ix._sorted_t if ix._sorted_t is not None else self._ZI32
        if ix._pending_words:
            pw, pt = ix._pending_raw()
        else:
            pw, pt = self._ZI64, self._ZI32
        p = ix.params
        args = (self._table.ctypes.data,
                p.alpha_size, p.word_length, p.slot_count,
                ix._starts.ctypes.data if has_csr else None,
                csr_post.ctypes.data if has_csr else None, csr_mode,
                sw.ctypes.data, st.ctypes.data, len(sw),
                pw.ctypes.data, pt.ctypes.data, len(pw),
                seq_count)
        # hold refs to EVERY array the cached pointers reference
        # (including the CSR arrays) so none can be freed or their ids
        # reused while the cache entry is alive
        self._db_cache = (key, args,
                          (sw, st, pw, pt, ix._starts, csr_post))
        return args

    def rank(self, seq: np.ndarray, bump_pct: int, mode: int):
        """mode 0 = SetTopBump(1,bump)+countsort; 1 = no-bump+countsort.
        Returns (tix int64, counts uint32) in ranked order."""
        seq_count = self.index.seq_count
        if seq_count == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.uint32))
        args = self._db_args(seq_count)
        if not seq.flags["C_CONTIGUOUS"]:
            seq = np.ascontiguousarray(seq)
        n = self.lib.usort_rank_c(
            self._scratch, seq.ctypes.data, len(seq), *args,
            bump_pct, mode, 0,
            self._out_tix.ctypes.data, self._out_counts.ctypes.data)
        return (self._out_tix[:n].astype(np.int64),
                self._out_counts[:n].copy())

    def rank_raw(self, seq: np.ndarray, bump_pct: int, mode: int):
        """rank() without the int64 cast/copies: returns a uint32 VIEW
        of the ranked target indexes, valid only until the next call."""
        seq_count = self.index.seq_count
        if seq_count == 0:
            return np.zeros(0, np.uint32)
        args = self._db_args(seq_count)
        if not seq.flags["C_CONTIGUOUS"]:
            seq = np.ascontiguousarray(seq)
        n = self.lib.usort_rank_c(
            self._scratch, seq.ctypes.data, len(seq), *args,
            bump_pct, mode, 0,
            self._out_tix.ctypes.data, self._out_counts.ctypes.data)
        return self._out_tix[:n]


class NativeAligner:
    """Per-thread native HSPFinder + scratch + global_align wrapper.
    Drop-in replacement for the (HSPFinder, global_align) pair."""

    def __init__(self, ap, ah) -> None:
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self.lib = lib
        self.ap = ap
        self.ah = ah
        from ..alpha import (CHAR_TO_LETTER_AMINO, CHAR_TO_LETTER_NUCLEO,
                             MATCH_MX_AMINO, MATCH_MX_NUCLEO)
        self._mx = np.ascontiguousarray(ap.subst_mx, dtype=np.float32)
        self._ctl = np.ascontiguousarray(
            CHAR_TO_LETTER_NUCLEO if ap.nucleo else CHAR_TO_LETTER_AMINO)
        self._match = np.ascontiguousarray(
            (MATCH_MX_NUCLEO if ap.nucleo else MATCH_MX_AMINO)
            .astype(np.uint8))
        alpha_size = 4 if ap.nucleo else 20
        self._hf = lib.hsp_create(ah.hsp_word_length, alpha_size,
                                  self._mx, self._ctl)
        self._scratch = lib.scratch_create()
        self._gp = GapParams.from_alnparams(ap)
        self._path_buf = ctypes.create_string_buffer(1 << 20)
        self._a = None
        self._la = 0

    def __del__(self):
        try:
            self.lib.hsp_destroy(self._hf)
            self.lib.scratch_destroy(self._scratch)
        except Exception:
            pass

    def set_a(self, a: np.ndarray) -> None:
        self._a = np.ascontiguousarray(a)
        self._la = len(a)
        self.lib.hsp_set_a(self._hf, self._a, self._la)

    def set_b(self, b: np.ndarray) -> None:
        self._b = np.ascontiguousarray(b)
        self._lb = len(b)
        self.lib.hsp_set_b(self._hf, self._b, self._lb)

    def global_align(self, full_dp_always: bool = False,
                     fail_if_no_hsps: bool = True) -> Optional[str]:
        need = self._la + self._lb + 2
        if need > len(self._path_buf):
            self._path_buf = ctypes.create_string_buffer(2 * need)
        fract = ctypes.c_float(0.0)
        ah = self.ah
        n = self.lib.global_align_c(
            self._hf, self._scratch, ctypes.byref(self._gp), self._match,
            ah.band_radius, ah.min_global_hsp_length,
            ah.min_global_hsp_fract_id, ah.min_global_hsp_score,
            ah.xdrop_global_hsp, int(full_dp_always), int(fail_if_no_hsps),
            self._path_buf, ctypes.byref(fract))
        if n == 0:
            return None
        if n < 0:
            raise RuntimeError(f"global_align_c error {n}")
        # NOT ._path_buf.raw[:n]: .raw copies the whole buffer (1 MB)
        return ctypes.string_at(self._path_buf, n).decode("ascii")

    def _ensure_id_mx(self) -> None:
        if getattr(self, "_id_mx", None) is None:
            from ..alpha import MATCH_MX_AMINO, MATCH_MX_NUCLEO
            self._id_mx = np.ascontiguousarray(
                (MATCH_MX_NUCLEO if self.ap.nucleo else MATCH_MX_AMINO)
                .astype(np.uint8))

    def set_db_view(self, seqs) -> None:
        """Concatenate the target DB for the C search loop."""
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        offs = np.zeros(max(len(seqs) + 1, 1), dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        self._db_concat = (np.concatenate(seqs).astype(np.uint8, copy=False)
                           if len(seqs) else np.zeros(0, np.uint8))
        self._db_offs = offs
        self._db_lens = lens
        self._db_n = len(seqs)
        self._db_total = int(offs[self._db_n])
        self._ensure_id_mx()

    def db_view_clear(self) -> None:
        """Growable DB view for clustering (centroid DB grows per admit);
        amortized O(1) appends via geometric growth."""
        self._db_concat = np.zeros(1 << 16, dtype=np.uint8)
        self._db_offs = np.zeros(1025, dtype=np.int64)
        self._db_lens = np.zeros(1024, dtype=np.int64)
        self._db_n = 0
        self._db_total = 0
        self._ensure_id_mx()

    def db_view_append(self, seq: np.ndarray) -> None:
        n = self._db_n
        L = len(seq)
        if n + 1 >= len(self._db_lens):
            self._db_lens = np.resize(self._db_lens, 2 * len(self._db_lens))
            self._db_offs = np.resize(self._db_offs,
                                      2 * len(self._db_offs))
        if self._db_total + L > len(self._db_concat):
            cap = max(2 * len(self._db_concat), self._db_total + L)
            new = np.zeros(cap, dtype=np.uint8)
            new[:self._db_total] = self._db_concat[:self._db_total]
            self._db_concat = new
        self._db_concat[self._db_total:self._db_total + L] = seq
        self._db_lens[n] = L
        self._db_offs[n] = self._db_total
        self._db_total += L
        self._db_offs[n + 1] = self._db_total
        self._db_n = n + 1

    def search_ranked(self, cand: np.ndarray, min_id: float, max_id: float,
                      has_max_id: bool, maxaccepts: int, maxrejects: int,
                      full_dp_always: bool, fail_if_no_hsps: bool):
        """C fast-path per-strand loop (search_ranked_c): align ranked
        candidates, -id accept, maxaccepts/maxrejects terminate.  The
        query must have been set with set_a.  Returns [(tix, path)]."""
        n_cand = len(cand)
        if n_cand == 0:
            return []
        cand32 = np.ascontiguousarray(cand, dtype=np.uint32)
        acc_tix = np.zeros(n_cand, dtype=np.uint32)
        acc_off = np.zeros(n_cand + 1, dtype=np.int64)
        ah = self.ah
        cap = 1 << 20
        while True:
            if cap > len(self._path_buf):
                self._path_buf = ctypes.create_string_buffer(cap)
            na = self.lib.search_ranked_c(
                self._hf, self._scratch, ctypes.byref(self._gp),
                self._match.ctypes.data,
                ah.band_radius, ah.min_global_hsp_length,
                ah.min_global_hsp_fract_id, ah.min_global_hsp_score,
                ah.xdrop_global_hsp, int(full_dp_always),
                int(fail_if_no_hsps),
                self._db_concat.ctypes.data, self._db_offs.ctypes.data,
                self._db_lens.ctypes.data,
                cand32.ctypes.data, n_cand,
                self._id_mx.ctypes.data,
                min_id, max_id, int(has_max_id),
                maxaccepts, maxrejects,
                acc_tix.ctypes.data, acc_off.ctypes.data,
                self._path_buf, len(self._path_buf))
            if na >= 0:
                break
            cap = 2 * len(self._path_buf)
        base = ctypes.addressof(self._path_buf)
        out = []
        for k in range(na):
            lo, hi = int(acc_off[k]), int(acc_off[k + 1])
            out.append((int(acc_tix[k]),
                        ctypes.string_at(base + lo, hi - lo)
                        .decode("ascii")))
        return out

    def global_chain(self, full_dp_always: bool = False,
                     fail_if_no_hsps: bool = True):
        """Chain-only pass for batched device hole alignment.  Returns
        ("fail", None) | ("fallback", None) | ("fulldp", None) |
        ("chain", hsps (n,4) uint32 array of loi/loj/leni/lenj)."""
        hsps = np.zeros((512, 4), dtype=np.uint32)
        fract = ctypes.c_float(0.0)
        ah = self.ah
        n = self.lib.global_chain_c(
            self._hf, self._scratch, self._match,
            ah.min_global_hsp_length, ah.min_global_hsp_fract_id,
            ah.min_global_hsp_score, ah.xdrop_global_hsp,
            int(full_dp_always), int(fail_if_no_hsps),
            hsps, ctypes.byref(fract))
        if n == -1:
            return "fail", None
        if n == -2:
            return "fallback", None
        if n == -3:
            return "fulldp", None
        return "chain", hsps[:n].copy()


_ps_tables = None


def path_stats(path_b: bytes, q: np.ndarray, t: np.ndarray,
               loi: int, loj: int, nucleo: bool):
    """C-backed AlignResult._fill core.  Returns an int64[10] array
    (first_m_col, last_m_col, first_m_qpos, first_m_tpos, last_m_qpos,
    last_m_tpos, id_count, diff_count_a, m_col_count, gap_open_count)
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    global _ps_tables
    if _ps_tables is None:
        from ..alpha import MATCH_MX_AMINO, MATCH_MX_NUCLEO, TO_UPPER
        _ps_tables = (
            np.ascontiguousarray(MATCH_MX_NUCLEO.astype(np.uint8)),
            np.ascontiguousarray(MATCH_MX_AMINO.astype(np.uint8)),
            np.ascontiguousarray(TO_UPPER),
        )
    mx = _ps_tables[0] if nucleo else _ps_tables[1]
    out = np.zeros(10, dtype=np.int64)
    rc = lib.path_stats_c(path_b, len(path_b), q.ctypes.data,
                          t.ctypes.data, loi, loj, mx.ctypes.data,
                          _ps_tables[2].ctypes.data, out.ctypes.data)
    if rc != 0:
        raise AssertionError("path with no M columns")
    return out
