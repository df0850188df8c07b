"""Native window driver for UCLUST greedy clustering.

Runs the exact serial greedy semantics of cluster/uclust.py
_greedy_cluster (src/clusterfast.cpp:119-129, src/clustersink.cpp:306-360)
with the per-query work — ranking, lazy candidate alignment,
accept/terminate, admission — in one C call per window
(cluster_greedy_c).  The window freezes the posting tiers; admissions
accumulate in a C-side delta tier that is folded back into the Python
index between windows, so candidate order is bit-identical to the
serial loop.  Outputs (uc records, centroids, clusters, constax) are
produced by the same writers as the serial path.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from ..config import options
from ..io.seqdb import SeqDB
from ..scoring import AlnParams, AlnHeuristics
from ..index.udb import UDBIndex, UDBParams
from ..search.terminator import Terminator
from ..search.driver import fast_loop_eligible
from ..native import GapParams, get_lib
from .. import progress


def cluster_engine_eligible() -> bool:
    o = options()
    if get_lib() is None or o.flag("use_cpu_oracle"):
        return False
    if o.flag("quicksort"):
        return False
    from ..search.accepter import Accepter
    return fast_loop_eligible(Accepter(is_global=True))


def greedy_cluster_engine(cmd: str, input_db: SeqDB, dr,
                          unique_db: SeqDB, order, nucleo: bool,
                          rev_comp: bool) -> bool:
    """Returns True if the run was handled natively (outputs written)."""
    o = options()
    if not cluster_engine_eligible():
        return False
    term = Terminator(cmd)
    if term.max_accepts <= 0 or term.max_rejects <= 0:
        return False
    lib = get_lib()
    ap = AlnParams.from_cmdline(nucleo)
    ah = AlnHeuristics.from_cmdline(ap)
    params = UDBParams.global_usearch(nucleo)
    index = UDBIndex(params)
    index.seq_count = 0

    from ..alpha import (CHAR_TO_COMP_CHAR, CHAR_TO_LETTER_AMINO,
                         CHAR_TO_LETTER_NUCLEO, IS_LOWER, MATCH_MX_AMINO,
                         MATCH_MX_NUCLEO, TO_UPPER)
    sub_mx = np.ascontiguousarray(ap.subst_mx, dtype=np.float32)
    ctl_aln = np.ascontiguousarray(
        CHAR_TO_LETTER_NUCLEO if nucleo else CHAR_TO_LETTER_AMINO)
    ctl_rank = ctl_aln.copy()
    ctl_rank[IS_LOWER] = 0xFF
    match = np.ascontiguousarray(
        (MATCH_MX_NUCLEO if nucleo else MATCH_MX_AMINO).astype(np.uint8))
    to_upper = np.ascontiguousarray(TO_UPPER)
    gp = GapParams.from_alnparams(ap)

    hf = lib.hsp_create(ah.hsp_word_length, 4 if nucleo else 20, sub_mx,
                        ctl_aln)
    asc = lib.scratch_create()
    es = lib.engine_scratch_create()
    cc = lib.cluster_ctx_create()
    try:
        return _run(cmd, lib, hf, asc, es, cc, gp, sub_mx, match,
                    to_upper, ctl_rank, ap, ah, term, params, index,
                    input_db, dr, unique_db, order, nucleo, rev_comp)
    finally:
        lib.hsp_destroy(hf)
        lib.scratch_destroy(asc)
        lib.engine_scratch_destroy(es)
        lib.cluster_ctx_destroy(cc)


def _run(cmd, lib, hf, asc, es, cc, gp, sub_mx, match, to_upper, ctl_rank,
         ap, ah, term, params, index, input_db, dr, unique_db, order,
         nucleo, rev_comp) -> bool:
    o = options()
    n = len(order)
    jobs_per = 2 if rev_comp else 1
    # pack query jobs in greedy order (fwd [+ revcomp])
    from ..alpha import CHAR_TO_COMP_CHAR
    parts: List[np.ndarray] = []
    lens = np.empty(n * jobs_per, np.int64)
    for k, ui in enumerate(order):
        s = unique_db.seqs[ui]
        parts.append(s)
        lens[k * jobs_per] = len(s)
        if rev_comp:
            parts.append(CHAR_TO_COMP_CHAR[s][::-1])
            lens[k * jobs_per + 1] = len(s)
    qbuf = (np.ascontiguousarray(np.concatenate(parts)) if parts
            else np.zeros(1, np.uint8))
    q_off = np.zeros(n * jobs_per + 1, np.int64)
    np.cumsum(lens, out=q_off[1:])

    min_id = o.flt("id") if o.filled("id") else -1.0
    has_max_id = o.filled("maxid")
    max_id = o.flt("maxid") if has_max_id else 1.0
    bump = o.uns("bump")

    out_assign = np.full(n, -1, np.int32)
    out_admit = np.zeros(n, np.uint8)
    out_hit_off = np.zeros(n + 1, np.int64)
    max_hits = max(4 * n, 1024)
    cpath_cap = 1 << 22
    hit_tix = np.empty(max_hits, np.int32)
    hit_rc = np.empty(max_hits, np.uint8)
    hit_pct = np.empty(max_hits, np.float64)
    hit_fract = np.empty(max_hits, np.float32)
    hit_cpath_off = np.zeros(max_hits + 1, np.int64)
    cpath_buf = np.empty(cpath_cap, np.uint8)
    counters = np.zeros(2, np.int64)

    progress.start("Clustering")
    pos = 0
    while pos < n:
        ret = lib.cluster_greedy_c(
            cc, hf, asc, es, ctypes.byref(gp), sub_mx.ctypes.data,
            match.ctypes.data, match.ctypes.data, to_upper.ctypes.data,
            ah.band_radius, ah.min_global_hsp_length,
            ah.min_global_hsp_fract_id, ah.min_global_hsp_score,
            ah.xdrop_global_hsp, int(ah.full_dp_always),
            int(not o.flag("gaforce")),
            ctl_rank.ctypes.data, params.alpha_size, params.word_length,
            params.slot_count,
            bump, min_id, max_id, int(has_max_id),
            term.max_accepts, term.max_rejects,
            qbuf.ctypes.data, q_off.ctypes.data, int(rev_comp), n, pos,
            out_assign.ctypes.data, out_admit.ctypes.data,
            out_hit_off.ctypes.data,
            hit_tix.ctypes.data, hit_rc.ctypes.data, hit_pct.ctypes.data,
            hit_fract.ctypes.data,
            hit_cpath_off.ctypes.data, cpath_buf.ctypes.data, cpath_cap,
            max_hits, counters.ctypes.data)
        if ret == -1:
            max_hits *= 4
            cpath_cap *= 4
            nh = int(counters[0])
            hit_tix = np.resize(hit_tix, max_hits)
            hit_rc = np.resize(hit_rc, max_hits)
            hit_pct = np.resize(hit_pct, max_hits)
            hit_fract = np.resize(hit_fract, max_hits)
            new_off = np.zeros(max_hits + 1, np.int64)
            new_off[:nh + 1] = hit_cpath_off[:nh + 1]
            hit_cpath_off = new_off
            cpath_buf = np.resize(cpath_buf, cpath_cap)
            continue
        pos = ret
        progress.tick(pos, n)
    progress.done()
    from .. import runlog
    runlog.note(f"Clustering: {n} uniques -> "
                f"{int(lib.cluster_ctx_db_n(cc))} clusters")

    _write_outputs(cmd, input_db, dr, unique_db, order, nucleo, rev_comp,
                   out_assign, out_admit, out_hit_off, hit_tix, hit_rc,
                   hit_pct, hit_fract, hit_cpath_off, cpath_buf)
    return True


def _uc_emit_native(path, n, order_arr, unique_db, out_assign,
                    out_hit_off, hit_tix, hit_rc, hit_pct,
                    hit_cpath_off, cpath_buf, centroid_q, bounds,
                    idxarr, dr, nucleo, state) -> bool:
    """H/S/C uc records via cluster_uc_emit_c; returns False (caller
    falls back to the Python writer) when a record has more than one
    hit (needs the quicksort tie order) or the lib is unavailable."""
    lib = get_lib()
    if lib is None or n == 0:
        return False
    if int(np.max(np.diff(out_hit_off[:n + 1]))) > 1:
        return False
    ulabs = [lab.encode("latin1") for lab in unique_db.labels]
    ulab_off = np.zeros(len(ulabs) + 1, np.int64)
    np.cumsum([len(x) for x in ulabs], out=ulab_off[1:])
    ulab_buf = np.frombuffer(b"".join(ulabs) or b"\0", np.uint8)
    ulen = np.fromiter((len(s) for s in unique_db.seqs), np.int64,
                       len(unique_db.seqs))
    centroid_ui = np.ascontiguousarray(order_arr[centroid_q], np.int64)
    expand = (bounds is not None
              and len(bounds) > 1
              and int(np.max(bounds[1:] - bounds[:-1])) > 1)
    if expand:
        ilabs = [lab.encode("latin1") for lab in dr.input_db.labels]
        ilab_off = np.zeros(len(ilabs) + 1, np.int64)
        np.cumsum([len(x) for x in ilabs], out=ilab_off[1:])
        ilab_buf = np.frombuffer(b"".join(ilabs) or b"\0", np.uint8)
        mb_ptr, mi_ptr = bounds.ctypes.data, idxarr.ctypes.data
        il_ptr, io_ptr = ilab_buf.ctypes.data, ilab_off.ctypes.data
        extra = int(ilab_buf.size) * 2
    else:
        mb_ptr = mi_ptr = il_ptr = io_ptr = None
        extra = 0
    asg = np.ascontiguousarray(out_assign[:n], np.int32)
    hoff = np.ascontiguousarray(out_hit_off[:n + 1], np.int64)
    cap = (int(ulab_buf.size) * 2 + int(cpath_buf.size) + 160 * n
           + extra + 1024)
    while True:
        out = np.empty(cap, np.uint8)
        ret = lib.cluster_uc_emit_c(
            n, order_arr.ctypes.data,
            ulab_buf.ctypes.data, ulab_off.ctypes.data,
            ulen.ctypes.data, asg.ctypes.data, hoff.ctypes.data,
            hit_tix.ctypes.data, hit_rc.ctypes.data,
            hit_pct.ctypes.data, hit_cpath_off.ctypes.data,
            cpath_buf.ctypes.data, centroid_ui.ctypes.data,
            mb_ptr, mi_ptr, il_ptr, io_ptr,
            int(nucleo), out.ctypes.data, cap)
        if ret >= 0:
            break
        cap *= 2
    with open(path, "wb") as f:
        f.write(out[:ret].tobytes())
        tail = []
        for ci, size in enumerate(state.cluster_sizes):
            tail.append(f"C\t{ci}\t{size}\t*\t*\t*\t*\t*\t"
                        f"{state.centroid_labels[ci]}\t*\n")
            if len(tail) >= 8192:
                f.write("".join(tail).encode("latin1"))
                tail = []
        f.write("".join(tail).encode("latin1"))
    return True


def _write_outputs(cmd, input_db, dr, unique_db, order, nucleo, rev_comp,
                   out_assign, out_admit, out_hit_off, hit_tix, hit_rc,
                   hit_pct, hit_fract, hit_cpath_off, cpath_buf) -> None:
    """Replays ClusterSink/OutputSink bookkeeping from the packed
    arrays: uc H/S/C records in query order, then centroids/clusters/
    constax via the shared writers (cluster/uclust.py)."""
    o = options()
    from ..cluster.uclust import (ClusterState, _write_centroids,
                                  _write_clusters, _write_constax_report)
    n = len(order)
    state = ClusterState(dr, unique_db)
    # rebuild cluster state in query order
    centroid_q = np.nonzero(out_admit)[0]
    n_clusters = len(centroid_q)
    for q in centroid_q:
        ui = order[q]
        state.centroid_labels.append(unique_db.labels[ui])
        state.centroid_seqs.append(unique_db.seqs[ui])
        state.cluster_to_centroid_seq.append(ui)

    order_arr = np.ascontiguousarray(order, dtype=np.int64)
    # member bounds/index arrays in unique-index space (None without dr)
    bounds = idxarr = None
    if dr is not None:
        mb = getattr(dr.members, "_bounds", None)
        if mb is not None:
            bounds = np.ascontiguousarray(mb, dtype=np.int64)
            idxarr = np.ascontiguousarray(dr.members._order,
                                          dtype=np.int64)
        else:
            nm = len(dr.members)
            lens = np.fromiter((len(m) for m in dr.members), np.int64,
                               nm)
            bounds = np.zeros(nm + 1, np.int64)
            np.cumsum(lens, out=bounds[1:])
            idxarr = (np.concatenate(
                [np.asarray(m, np.int64) for m in dr.members])
                if nm else np.zeros(0, np.int64))

    if not o.flag("sizein"):
        # every member counts 1 (vectorized ClusterSink::GetSize)
        if bounds is not None:
            mcounts = (bounds[1:] - bounds[:-1])[order_arr].astype(
                np.float64)
        else:
            mcounts = np.ones(n, np.float64)
        sizes = np.bincount(out_assign[:n], weights=mcounts,
                            minlength=n_clusters).astype(np.int64) \
            .tolist()
    else:
        sizes = [0] * n_clusters
        for q in range(n):
            ui = order[q]
            sizes[int(out_assign[q])] += state.get_size(
                ui, unique_db.labels[ui])
    state.cluster_sizes = sizes
    if o.filled("clusters") or o.filled("constax_report"):
        for q in range(n):
            state.seq_to_cluster[order[q]] = int(out_assign[q])

    if o.filled("uc") and _uc_emit_native(
            o.str("uc"), n, order_arr, unique_db, out_assign,
            out_hit_off, hit_tix, hit_rc, hit_pct, hit_cpath_off,
            cpath_buf, centroid_q, bounds, idxarr, dr, nucleo, state):
        f_uc = None
    else:
        f_uc = open(o.str("uc"), "w") if o.filled("uc") else None
    if f_uc:
        cbytes = cpath_buf.tobytes()
        lines = []
        for q in range(n):
            ui = order[q]
            q_label = unique_db.labels[ui]
            lo, hi = int(out_hit_off[q]), int(out_hit_off[q + 1])
            if hi > lo:
                hs = list(range(lo, hi))
                if len(hs) > 1:
                    from ..search.hitmgr import quick_sort_order
                    scores = [hit_fract[h] for h in hs]
                    hs = [hs[i] for i in quick_sort_order(scores,
                                                          desc=True)]
                la = len(unique_db.seqs[ui])
                for h in hs:
                    strand = "."
                    if nucleo:
                        strand = "-" if hit_rc[h] else "+"
                    cp = cbytes[hit_cpath_off[h]:hit_cpath_off[h + 1]] \
                        .decode("ascii")
                    t_label = state.centroid_labels[hit_tix[h]]
                    line = (f"H\t{hit_tix[h]}\t{la}\t{hit_pct[h]:.1f}\t"
                            f"{strand}\t0\t0\t{cp}\t{q_label}\t"
                            f"{t_label}\n")
                    lines.append(line)
                    if dr is not None:
                        for si in dr.members[ui][1:]:
                            lines.append(
                                (f"H\t{hit_tix[h]}\t{la}\t"
                                 f"{hit_pct[h]:.1f}\t{strand}\t0\t0\t"
                                 f"{cp}\t{dr.input_db.labels[si]}\t"
                                 f"{t_label}\n"))
            else:
                ci = int(out_assign[q])
                L = len(unique_db.seqs[ui])
                lines.append(f"S\t{ci}\t{L}\t*\t.\t*\t*\t*\t{q_label}\t*\n")
                if dr is not None:
                    for si in dr.members[ui][1:]:
                        lbl = dr.input_db.labels[si]
                        lines.append(f"H\t{ci}\t{L}\t100.0\t.\t0\t{L}\t=\t"
                                     f"{lbl}\t{q_label}\n")
            if len(lines) > 4096:
                f_uc.write("".join(lines))
                lines = []
        for ci, size in enumerate(state.cluster_sizes):
            lines.append(f"C\t{ci}\t{size}\t*\t*\t*\t*\t*\t"
                         f"{state.centroid_labels[ci]}\t*\n")
        f_uc.write("".join(lines))
        f_uc.close()

    if o.filled("centroids"):
        _write_centroids(o.str("centroids"), state)
    if o.filled("clusters"):
        _write_clusters(o.str("clusters"), state, dr, unique_db)
    if o.filled("constax_report"):
        _write_constax_report(o.str("constax_report"), state, dr,
                              unique_db)
