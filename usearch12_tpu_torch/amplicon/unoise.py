"""UNOISE3 amplicon denoising (src/unoise3.cpp).

Greedy: for each size-sorted unique read, GetHot finds the top-8 centroids
by shared words (max word-count drop 8), each is globally aligned, and the
read is absorbed as a "bad/shifted" child if skew >= 2^(alpha*d + 1)
(mismatch diffs d); otherwise it founds a new centroid.  Amplicons are then
chimera-filtered with Uchime2DeNovo and surviving ZOTUs written.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..config import options
from ..io.seqdb import SeqDB, size_from_label
from ..io.fastx import write_fasta
from ..scoring import AlnParams, AlnHeuristics
from ..index.udb import UDBIndex, UDBParams
from ..search.usorted import USortedRanker
from ..align.result import AlignResult
from .uchime import uchime2_denovo, acc_from_label

MAX_HOT = 8
MAX_DROP = 8


def _is_accept(ar: AlignResult, alpha: float) -> bool:
    """IsAccept (src/unoise3.cpp:24-60): skew >= 2^(alpha*d + 1)."""
    diffs = ar.get_mismatch_count()
    if diffs == 0:
        return True
    qsize = size_from_label(ar.query_label, 0xFFFFFFFF)
    tsize = size_from_label(ar.target_label, 0xFFFFFFFF)
    skew = tsize / qsize
    min_skew = math.pow(2.0, diffs * alpha + 1.0)
    return skew >= min_skew


def _unoise_greedy_native(input_db, uniq_count, alpha, max_accepts,
                          ap, ah):
    """Whole greedy denoise loop via unoise_greedy_c (ClusterCtx 3-tier
    index + HSP-anchored aligns in one C call).  Returns
    (out_ti, out_diffs) int32 arrays or None."""
    import ctypes
    from ..native import get_lib, GapParams
    lib = get_lib()
    if lib is None or uniq_count == 0:
        return None
    from ..alpha import (CHAR_TO_LETTER_NUCLEO, MATCH_MX_NUCLEO,
                        IS_LOWER)
    o = options()
    bb = getattr(input_db, "_bulk_buf", None)
    if bb is not None and len(getattr(input_db, "_bulk_off", ())) > uniq_count:
        # bulk-parse fast path: seqs are consecutive in one buffer from
        # offset 0, so the C call can use it directly (no re-concat)
        offs = np.ascontiguousarray(input_db._bulk_off[:uniq_count + 1])
        qbuf = bb
    else:
        seqs = input_db.seqs[:uniq_count]
        lens = np.fromiter((len(s) for s in seqs), np.int64, uniq_count)
        offs = np.zeros(uniq_count + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        qbuf = np.concatenate([np.ascontiguousarray(s) for s in seqs])
    from ..io.seqdb import sizes_bulk
    qsizes = sizes_bulk(input_db, uniq_count, 0xFFFFFFFF)
    mx = np.ascontiguousarray(ap.subst_mx, dtype=np.float32)
    ctl = np.ascontiguousarray(CHAR_TO_LETTER_NUCLEO)
    ctl_rank = CHAR_TO_LETTER_NUCLEO.copy()
    ctl_rank[IS_LOWER] = 0xFF
    ctl_rank = np.ascontiguousarray(ctl_rank)
    match_u8 = np.ascontiguousarray(MATCH_MX_NUCLEO.astype(np.uint8))
    gp = GapParams.from_alnparams(ap)
    params = UDBParams.global_usearch(True)
    cc = lib.cluster_ctx_create()
    hf = lib.hsp_create(ah.hsp_word_length, 4, mx, ctl)
    as_ = lib.scratch_create()
    es = lib.engine_scratch_create()
    out_ti = np.empty(uniq_count, np.int32)
    out_diffs = np.empty(uniq_count, np.int32)
    try:
        lib.unoise_greedy_c(
            cc, hf, as_, es, ctypes.byref(gp), match_u8.ctypes.data,
            ah.band_radius, ah.min_global_hsp_length,
            ah.min_global_hsp_fract_id, ah.min_global_hsp_score,
            ah.xdrop_global_hsp,
            ctl_rank.ctypes.data, params.alpha_size,
            params.word_length, params.slot_count, o.uns("bump"),
            float(alpha), max_accepts,
            qbuf.ctypes.data, offs.ctypes.data, uniq_count,
            qsizes.ctypes.data,
            out_ti.ctypes.data, out_diffs.ctypes.data)
    finally:
        lib.cluster_ctx_destroy(cc)
        lib.hsp_destroy(hf)
        lib.scratch_destroy(as_)
        lib.engine_scratch_destroy(es)
    return out_ti, out_diffs


def unoise3(input_path: Optional[str]) -> None:
    o = options()
    if o.filled("fastaout"):
        raise SystemExit("-fastaout not supported, use -zotus")
    o.set_default("abskew", 16.0)

    f_tab = open(o.str("tabbedout"), "w") if o.filled("tabbedout") else None

    # lazy: the input is size-sorted and only the >= minsize head (often
    # a few % of a 300k-record uniques file) is ever touched
    input_db = SeqDB.from_fastx(input_path, lazy=True)
    input_db.set_is_nucleo(True)
    nucleo = True
    ap = AlnParams.from_cmdline(nucleo)
    ah = AlnHeuristics.from_cmdline(ap)
    alpha = o.flt("unoise_alpha")
    max_accepts = o.uns("maxaccepts", 1)

    native = None
    try:
        from ..native import NativeAligner
        native = NativeAligner(ap, ah)
    except Exception:
        from ..align.hsp import HSPFinder
        from ..align.global_aligner import global_align as _ga
        hf = HSPFinder(ap, ah)

    def align(q_seq, t_seq):
        # GlobalAligner with m_FailIfNoHSPs = true (src/unoise3.cpp:145)
        if native is not None:
            native.set_b(t_seq)
            return native.global_align(fail_if_no_hsps=True)
        hf.set_a(q_seq)
        hf.set_b(t_seq)
        return _ga(q_seq, t_seq, ap, ah, hf, fail_if_no_hsps=True)

    params = UDBParams.global_usearch(True)
    index = UDBIndex(params)
    ranker = USortedRanker(index)

    min_amp_size = o.uns("minsize") if o.filled("minsize") else 8
    n_input = len(input_db)
    uniq_count = n_input
    from ..io.seqdb import sizes_bulk
    all_sizes = sizes_bulk(input_db, n_input, 0xFFFFFFFF)
    below = np.nonzero(all_sizes < min_amp_size)[0]
    if len(below):
        uniq_count = int(below[0])

    centroid_labels = []
    centroid_seqs = []

    def search_denoise(q_label, q_seq):
        """SearchDenoise (src/unoise3.cpp:72-118)."""
        hot = ranker.get_hot(q_seq, MAX_HOT, MAX_DROP)
        if len(hot) == 0:
            return 0xFFFFFFFF, 0xFFFFFFFF
        if native is not None:
            native.set_a(q_seq)
        best_t = 0xFFFFFFFF
        best_diffs = 0xFFFFFFFF
        accept_count = 0
        for ti in hot.tolist():
            path = align(q_seq, centroid_seqs[ti])
            if path is not None:
                ar = AlignResult(query_label=q_label,
                                 target_label=centroid_labels[ti],
                                 query_seq=q_seq,
                                 target_seq=centroid_seqs[ti],
                                 path=path, nucleo=True, target_index=ti)
                if _is_accept(ar, alpha):
                    accept_count += 1
                    diffs = ar.get_mismatch_count()
                    if diffs < best_diffs:
                        best_t = ti
                        best_diffs = diffs
            if best_diffs <= 1:
                break
            if accept_count >= max_accepts:
                break
        return best_t, best_diffs

    nat = _unoise_greedy_native(input_db, uniq_count, alpha,
                                max_accepts, ap, ah)
    if nat is not None:
        out_ti, out_diffs = nat
        for seq_index in range(uniq_count):
            q_label = input_db.labels[seq_index]
            ti = int(out_ti[seq_index])
            if ti >= 0:
                if f_tab:
                    diffs = int(out_diffs[seq_index])
                    top_acc = acc_from_label(centroid_labels[ti])
                    kind = "shifted" if diffs == 0 else "bad"
                    f_tab.write(f"{q_label}\tdenoise\t{kind}\t"
                                f"dqt={diffs};top={top_acc};\n")
            else:
                ti = len(centroid_labels)
                centroid_labels.append(q_label)
                centroid_seqs.append(input_db.seqs[seq_index])
                if f_tab:
                    f_tab.write(f"{q_label}\tdenoise\tamp{ti + 1}\n")
    else:
        for seq_index in range(uniq_count):
            q_label = input_db.labels[seq_index]
            q_seq = input_db.seqs[seq_index]
            qsize = size_from_label(q_label, 0xFFFFFFFF)
            assert qsize >= min_amp_size
            ti, diffs = search_denoise(q_label, q_seq)
            if ti != 0xFFFFFFFF:
                if f_tab:
                    top_acc = acc_from_label(centroid_labels[ti])
                    kind = "shifted" if diffs == 0 else "bad"
                    f_tab.write(f"{q_label}\tdenoise\t{kind}\t"
                                f"dqt={diffs};top={top_acc};\n")
            else:
                ti = len(centroid_labels)
                centroid_labels.append(q_label)
                centroid_seqs.append(q_seq)
                index.add_seq(ti, q_seq)
                index.seq_count = ti + 1
                if f_tab:
                    f_tab.write(f"{q_label}\tdenoise\tamp{ti + 1}\n")

    # relabel Amp%u and chimera-filter (src/unoise3.cpp:237-265)
    amp_db = SeqDB()
    amp_db.set_is_nucleo(True)
    last_size = 0xFFFFFFFF
    for amp_index, (label, seq) in enumerate(zip(centroid_labels,
                                                 centroid_seqs)):
        size = size_from_label(label, 0xFFFFFFFF)
        assert size <= last_size, "amplicons not sorted by size"
        last_size = size
        acc = acc_from_label(label)
        amp_db.add(f"Amp{amp_index + 1};uniq={acc};size={size};", seq)

    is_chimera_vec, info_strs = uchime2_denovo(amp_db)

    f_amp = open(o.str("ampout"), "w") if o.filled("ampout") else None
    otu_count = 0
    amp_to_otu = []
    for amp_index in range(len(amp_db)):
        # ORIGINAL centroid label here, not the Amp relabel
        # (src/unoise3.cpp:294-307 reads from the centroid DB)
        label = centroid_labels[amp_index]
        if is_chimera_vec[amp_index]:
            amp_to_otu.append(0xFFFFFFFF)
            amp_type = "amptype=chimera;" + info_strs[amp_index]
        else:
            amp_to_otu.append(otu_count)
            otu_count += 1
            amp_type = "amptype=otu;"
        if f_amp:
            write_fasta(f_amp, label + amp_type, centroid_seqs[amp_index],
                        o.uns("fasta_cols"))
        if f_tab:
            if is_chimera_vec[amp_index]:
                f_tab.write(f"{label}\tchfilter\tchimera\t"
                            f"{info_strs[amp_index]}\n")
            else:
                f_tab.write(f"{label}\tchfilter\tzotu\n")
    if f_amp:
        f_amp.close()

    if o.filled("zotus"):
        with open(o.str("zotus"), "w") as f:
            for amp_index in range(len(amp_db)):
                if is_chimera_vec[amp_index]:
                    continue
                write_fasta(f, f"Zotu{amp_to_otu[amp_index] + 1}",
                            amp_db.seqs[amp_index], o.uns("fasta_cols"))
    if f_tab:
        f_tab.close()
