"""UCLUST greedy centroid clustering: cluster_fast / cluster_smallmem.

Pipeline parity with the reference (src/clusterfast.cpp:81-133,
src/clustersink.cpp:306-359, src/outputuc.cpp, src/makeclustersearcher.cpp):
  load -> derep_full -> optional length/size sort -> greedy loop against a
  growing UDB (top hit joins the cluster, miss becomes a new centroid) ->
  UC / centroids / clusters outputs.

TPU note: the greedy loop is sequential by construction (query i's target
set includes centroids admitted by queries < i).  The batch-synchronous
device schedule (cluster_mt's pending scheme, src/clustermt.cpp:46-123)
lives in parallel/cluster_batch.py; this module is the exact host path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import options
from ..io.seqdb import SeqDB, size_from_label, strip_size, relabel_with_size
from ..io.fastx import write_fasta
from ..scoring import AlnParams, AlnHeuristics
from ..index.udb import UDBIndex, UDBParams
from ..search.accepter import Accepter
from ..search.terminator import Terminator
from ..search.hitmgr import HitMgr, quick_sort_order
from ..search.usorted import USortedRanker
from ..align.result import AlignResult
from .derep import DerepResult, derep_full


class ClusterState:
    """ClusterSink equivalent."""

    def __init__(self, dr: Optional[DerepResult], unique_db: SeqDB) -> None:
        self.dr = dr
        self.unique_db = unique_db
        self.cluster_sizes: List[int] = []
        self.centroid_labels: List[str] = []
        self.centroid_seqs: List[np.ndarray] = []
        self.seq_to_cluster = {}
        self.cluster_to_centroid_seq = []

    def get_size(self, unique_index: int, label: str) -> int:
        """ClusterSink::GetSize (src/clustersink.cpp:118-143)."""
        o = options()
        if not o.flag("sizein"):
            # every member counts 1, including the unique itself
            if self.dr is not None:
                return int(len(self.dr.members[unique_index]))
            return 1
        size = size_from_label(label, 1 << 31)
        if self.dr is not None:
            for si in self.dr.members[unique_index][1:]:
                size += size_from_label(self.dr.input_db.labels[si],
                                        1 << 31)
        return size

    def on_query_done(self, unique_index: int, label: str,
                      seq: np.ndarray, top_hit) -> int:
        size = self.get_size(unique_index, label)
        if top_hit is None:
            ci = len(self.cluster_sizes)
            self.cluster_sizes.append(size)
            self.centroid_labels.append(label)
            self.centroid_seqs.append(seq)
            self.cluster_to_centroid_seq.append(unique_index)
        else:
            ci = top_hit.target_index
            self.cluster_sizes[ci] += size
        self.seq_to_cluster[unique_index] = ci
        return ci


def _uc_hit_line(ar: AlignResult, query_label: str) -> str:
    """OutputUC (src/outputuc.cpp:45-68)."""
    strand = "."
    if ar.nucleo:
        strand = "-" if ar.query_revcomp else "+"
    return (f"H\t{ar.target_index}\t{ar.la}\t{ar.get_pct_id():.1f}\t{strand}"
            f"\t0\t0\t{ar.compressed_path()}\t{query_label}"
            f"\t{ar.target_label}\n")


def cluster_fast(input_path: Optional[str]) -> None:
    o = options()
    if not o.filled("id"):
        raise SystemExit("Must specify -id")
    if o.str("sort", "") == "other":
        raise SystemExit("-cluster_fast does not support -sort other")

    rev_comp = o.str("strand", "plus") == "both"
    input_db = SeqDB.from_fastx(input_path)
    if len(input_db) == 0:
        raise SystemExit("No sequences in input file")
    nucleo = input_db.get_is_nucleo()

    dr = derep_full(input_db, revcomp_ok=rev_comp)
    unique_db = dr.to_seqdb()
    n_unique = dr.cluster_count

    order = list(range(n_unique))
    sort_name = o.str("sort", "")
    if sort_name == "length":
        lens = [len(unique_db.seqs[i]) for i in range(n_unique)]
        order = quick_sort_order(lens, desc=True)
    elif sort_name == "size":
        sizes = [dr.sum_size_in(i) for i in range(n_unique)]
        order = quick_sort_order(sizes, desc=True)
    elif sort_name not in ("", "other", "user"):
        raise SystemExit(f"Invalid sort name {sort_name}")

    _greedy_cluster("cluster_fast", input_db, dr, unique_db, order, nucleo,
                    rev_comp)


def cluster_smallmem(input_path: Optional[str]) -> None:
    """cluster_smallmem: streaming greedy loop, input must be pre-sorted
    (src/clustersmallmem.cpp).  No dereplication."""
    o = options()
    if not o.filled("id"):
        raise SystemExit("Must specify -id")
    if not o.filled("sortedby"):
        raise SystemExit(
            "-cluster_smallmem requires -sortedby length|size|other")
    sortedby = o.str("sortedby")
    input_db = SeqDB.from_fastx(input_path)
    nucleo = input_db.get_is_nucleo()
    rev_comp = o.str("strand", "plus") == "both"
    # validate ordering like the reference
    if sortedby == "length":
        lens = [len(s) for s in input_db.seqs]
        if any(lens[i] < lens[i + 1] for i in range(len(lens) - 1)):
            raise SystemExit("not sorted by length, use -sortedby other")
    elif sortedby == "size":
        sz = [size_from_label(l, 1) for l in input_db.labels]
        if any(sz[i] < sz[i + 1] for i in range(len(sz) - 1)):
            raise SystemExit("not sorted by size")
    _greedy_cluster("cluster_smallmem", input_db, None, input_db,
                    list(range(len(input_db))), nucleo, rev_comp)


def _greedy_cluster(cmd: str, input_db: SeqDB, dr: Optional[DerepResult],
                    unique_db: SeqDB, order, nucleo: bool,
                    rev_comp: bool) -> None:
    o = options()
    if not o.flag("use_serial_driver"):
        from ..engine.cluster import greedy_cluster_engine
        if greedy_cluster_engine(cmd, input_db, dr, unique_db, order,
                                 nucleo, rev_comp):
            return
    ap = AlnParams.from_cmdline(nucleo)
    ah = AlnHeuristics.from_cmdline(ap)
    params = UDBParams.global_usearch(nucleo)
    index = UDBIndex(params)
    index.seq_count = 0
    ranker = USortedRanker(index)
    accepter = Accepter(is_global=True)
    terminator = Terminator(cmd)
    state = ClusterState(dr, unique_db)

    native = None
    if not o.flag("use_cpu_oracle"):
        try:
            from ..native import NativeAligner
            native = NativeAligner(ap, ah)
        except Exception:
            native = None
    from ..align.hsp import HSPFinder
    from ..align.global_aligner import global_align
    hf = HSPFinder(ap, ah)

    f_uc = open(o.str("uc"), "w") if o.filled("uc") else None
    fail_if_no_hsps = not o.flag("gaforce")

    def align_one(q_seq, t_seq):
        if native is not None:
            native.set_b(t_seq)
            return native.global_align(full_dp_always=ah.full_dp_always,
                                       fail_if_no_hsps=fail_if_no_hsps)
        hf.set_b(t_seq)
        return global_align(q_seq, t_seq, ap, ah, hf,
                            full_dp_always=ah.full_dp_always,
                            fail_if_no_hsps=fail_if_no_hsps)

    centroid_seqs: List[np.ndarray] = []  # index-aligned with state clusters

    from ..search.driver import fast_loop_eligible, fast_search_hits
    from .. import progress
    fast = native is not None and fast_loop_eligible(accepter)
    if fast:
        native.db_view_clear()

    progress.start("Clustering")
    n_done = 0
    for unique_index in order:
        n_done += 1
        progress.tick(n_done, len(order))
        q_label = unique_db.labels[unique_index]
        q_seq = unique_db.seqs[unique_index]
        hm = HitMgr()
        terminator.on_new_query()

        strands = [(q_seq, False)]
        if rev_comp:
            from ..alpha import revcomp as rc
            strands.append((rc(q_seq), True))
        for q_strand_seq, is_rc in strands:
            if is_rc:
                terminator.on_new_query()
            tix_order, _counts = ranker.rank(q_strand_seq)
            if len(tix_order) == 0:
                continue
            if fast:
                hits = fast_search_hits(native, q_strand_seq, tix_order,
                                        terminator.max_accepts,
                                        terminator.max_rejects,
                                        ah.full_dp_always)
                for tix, path in hits:
                    hm.append_hit(AlignResult(
                        query_label=q_label,
                        target_label=state.centroid_labels[tix],
                        query_seq=q_strand_seq,
                        target_seq=centroid_seqs[tix], path=path,
                        nucleo=nucleo, target_index=tix,
                        query_revcomp=is_rc))
                if hits and not rev_comp:
                    break
                continue
            if native is not None:
                native.set_a(q_strand_seq)
            else:
                hf.set_a(q_strand_seq)
            done = False
            for tix in tix_order.tolist():
                t_label = state.centroid_labels[tix]
                t_seq = centroid_seqs[tix]
                if accepter.reject_pair(q_label, q_strand_seq,
                                        t_label, t_seq):
                    continue
                path = align_one(q_strand_seq, t_seq)
                accept = False
                if path is not None:
                    ar = AlignResult(query_label=q_label,
                                     target_label=t_label,
                                     query_seq=q_strand_seq,
                                     target_seq=t_seq, path=path,
                                     nucleo=nucleo, target_index=tix,
                                     query_revcomp=is_rc)
                    accept = accepter.is_accept(ar)
                    if accept:
                        hm.append_hit(ar)
                if terminator.terminate(hm, accept):
                    done = True
                    break
            if done and not rev_comp:
                break

        top = hm.top_hit()
        ci = state.on_query_done(unique_index, q_label, q_seq, top)
        if top is None:
            centroid_seqs.append(q_seq)
            index.add_seq(ci, q_seq)
            index.seq_count = ci + 1
            if fast:
                native.db_view_append(q_seq)

        # UC records (OutputSink::OnQueryDone order: sorted hits then
        # matched/unmatched extras)
        if f_uc:
            ordered = hm.sorted_hits()
            for ar in ordered:
                f_uc.write(_uc_hit_line(ar, q_label))
                if dr is not None:
                    for si in dr.members[unique_index][1:]:
                        f_uc.write(_uc_hit_line(
                            ar, dr.input_db.labels[si]))
            if not ordered:
                L = len(q_seq)
                f_uc.write(f"S\t{ci}\t{L}\t*\t.\t*\t*\t*\t{q_label}\t*\n")
                if dr is not None:
                    for si in dr.members[unique_index][1:]:
                        lbl = dr.input_db.labels[si]
                        f_uc.write(f"H\t{ci}\t{L}\t100.0\t.\t0\t{L}\t=\t"
                                   f"{lbl}\t{q_label}\n")

    progress.done(f"{len(state.cluster_sizes)} clusters")

    # C records + centroids output (ClusterSink::OnAllDone)
    if f_uc:
        for ci, size in enumerate(state.cluster_sizes):
            f_uc.write(f"C\t{ci}\t{size}\t*\t*\t*\t*\t*\t"
                       f"{state.centroid_labels[ci]}\t*\n")
        f_uc.close()

    if o.filled("centroids"):
        _write_centroids(o.str("centroids"), state)
    if o.filled("clusters"):
        _write_clusters(o.str("clusters"), state, dr, unique_db)
    if o.filled("constax_report"):
        _write_constax_report(o.str("constax_report"), state, dr,
                              unique_db)


def _write_centroids(path: str, state: ClusterState) -> None:
    """CentroidsToFASTA: cluster-size descending order
    (src/clustersink.cpp:246-273)."""
    o = options()
    order = quick_sort_order(state.cluster_sizes, desc=True)
    relabel_counter = 0
    minsize = o.uns("minsize", 0)
    strip = o.flag("sizein") or o.flag("sizeout")
    relabel = o.str("relabel") if o.filled("relabel") else None
    sizeout = o.flag("sizeout")
    cols = o.uns("fasta_cols")
    with open(path, "w") as f:
        chunks = []
        for ci in order:
            size = state.cluster_sizes[ci]
            if size < minsize:
                break
            label = state.centroid_labels[ci]
            if strip:
                label = strip_size(label)
            if relabel is not None:
                relabel_counter += 1
                label = f"{relabel}{relabel_counter}"
            if sizeout:
                label = relabel_with_size(label, size)
            s = state.centroid_seqs[ci].tobytes().decode("latin1")
            if cols <= 0:
                chunks.append(f">{label}\n{s}\n")
            else:
                body = "\n".join(s[i:i + cols]
                                 for i in range(0, len(s), cols))
                chunks.append(f">{label}\n{body}\n" if s
                              else f">{label}\n\n")
            if len(chunks) >= 4096:
                f.write("".join(chunks))
                chunks = []
        f.write("".join(chunks))


def _write_clusters(prefix: str, state: ClusterState,
                    dr: Optional[DerepResult], unique_db: SeqDB) -> None:
    """-clusters per-cluster FASTA files (src/clustersink.cpp:545-580)."""
    o = options()
    n_clusters = len(state.cluster_sizes)
    members_by_cluster = [[] for _ in range(n_clusters)]
    for ui in sorted(state.seq_to_cluster):
        members_by_cluster[state.seq_to_cluster[ui]].append(ui)
    for ci in range(n_clusters):
        centroid_ui = state.cluster_to_centroid_seq[ci]
        uis = [centroid_ui] + [u for u in members_by_cluster[ci]
                               if u != centroid_ui]
        with open(f"{prefix}{ci}", "w") as f:
            for ui in uis:
                if dr is not None:
                    for si in dr.members[ui]:
                        write_fasta(f, dr.input_db.labels[si],
                                    dr.input_db.seqs[si],
                                    o.uns("fasta_cols"))
                else:
                    write_fasta(f, unique_db.labels[ui], unique_db.seqs[ui],
                                o.uns("fasta_cols"))


class MtCentroids:
    """cluster_mt's centroid set (src/clustermt.cpp) and the search of one
    query against it: the UDB index of the centroids, the aligner (the C
    fast loop where it applies) and the accept/terminate replay in a
    candidate order.  The host path ranks with USortedRanker;
    parallel/cluster_batch.py ranks from word counts made on the card and
    aligns here, so both write the same bytes."""

    def __init__(self, input_path: Optional[str]) -> None:
        o = options()
        if not o.filled("id"):
            raise SystemExit("Must set -id")
        self.max_pending = (o.uns("maxpending") if o.filled("maxpending")
                            else 128)
        self.nucleo = SeqDB.from_fastx(input_path).get_is_nucleo()
        self.ap = AlnParams.from_cmdline(self.nucleo)
        self.ah = AlnHeuristics.from_cmdline(self.ap)
        self.index = UDBIndex(UDBParams.global_usearch(self.nucleo))
        self.ranker = USortedRanker(self.index)
        self.accepter = Accepter(is_global=True)
        self.terminator = Terminator("cluster_mt")
        self.native = None
        if not o.flag("use_cpu_oracle"):
            try:
                from ..native import NativeAligner
                self.native = NativeAligner(self.ap, self.ah)
            except Exception:
                self.native = None
        from ..align.hsp import HSPFinder
        self.hf = HSPFinder(self.ap, self.ah)
        self.fail = not o.flag("gaforce")
        self.labels: List[str] = []
        self.seqs: List[np.ndarray] = []
        from ..search.driver import fast_loop_eligible
        self.fast = (self.native is not None
                     and fast_loop_eligible(self.accepter))
        if self.fast:
            self.native.db_view_clear()

    def search(self, q_label, q_seq, tix_order=None):
        """Top hit (AlignResult) of the query among the centroids, or None;
        tix_order: the candidates in rank order (default: the host
        ranker's)."""
        from ..align.global_aligner import global_align
        from ..search.driver import fast_search_hits
        hm = HitMgr()
        term = self.terminator
        term.on_new_query()
        if tix_order is None:
            tix_order, _c = self.ranker.rank(q_seq)
        if not len(tix_order):
            return None
        native, nucleo = self.native, self.nucleo
        if self.fast:
            hits = fast_search_hits(native, q_seq, np.asarray(tix_order),
                                    term.max_accepts, term.max_rejects,
                                    self.ah.full_dp_always)
            for tix, path in hits:
                hm.append_hit(AlignResult(
                    query_label=q_label, target_label=self.labels[tix],
                    query_seq=q_seq, target_seq=self.seqs[tix],
                    path=path, nucleo=nucleo, target_index=tix))
            return hm.top_hit()
        if native is not None:
            native.set_a(q_seq)
        else:
            self.hf.set_a(q_seq)
        for tix in np.asarray(tix_order).tolist():
            t_label = self.labels[tix]
            t_seq = self.seqs[tix]
            if self.accepter.reject_pair(q_label, q_seq, t_label, t_seq):
                continue
            if native is not None:
                native.set_b(t_seq)
                path = native.global_align(fail_if_no_hsps=self.fail)
            else:
                self.hf.set_b(t_seq)
                path = global_align(q_seq, t_seq, self.ap, self.ah, self.hf,
                                    fail_if_no_hsps=self.fail)
            accept = False
            if path is not None:
                ar = AlignResult(query_label=q_label, target_label=t_label,
                                 query_seq=q_seq, target_seq=t_seq,
                                 path=path, nucleo=nucleo, target_index=tix)
                accept = self.accepter.is_accept(ar)
                if accept:
                    hm.append_hit(ar)
            if term.terminate(hm, accept):
                break
        return hm.top_hit()

    def admit(self, q_label, q_seq) -> int:
        ci = len(self.labels)
        self.labels.append(q_label)
        self.seqs.append(q_seq)
        self.index.add_seq(ci, q_seq)
        self.index.seq_count = ci + 1
        if self.fast:
            self.native.db_view_append(q_seq)
        return ci

    def write_centroids(self) -> None:
        o = options()
        if o.filled("centroids"):
            with open(o.str("centroids"), "w") as f:
                for lbl, s in zip(self.labels, self.seqs):
                    write_fasta(f, lbl, s, o.uns("fasta_cols"))


def cluster_mt(input_path: Optional[str]) -> None:
    """cluster_mt (src/clustermt.cpp): batch-synchronous greedy clustering.

    Queries stream against the frozen centroid set; misses buffer as
    "pending" until maxpending (128), then are re-searched serially with
    admissions applied in order.  This is the schedule that makes greedy
    clustering batchable on a device: the search phase is embarrassingly
    parallel over the pending window, admissions are serialized
    (parallel/cluster_batch.py)."""
    o = options()
    mt = MtCentroids(input_path)
    f_uc = open(o.str("uc"), "w") if o.filled("uc") else None
    from ..io.fastx import read_fastx
    pending = []
    for label, seq, _qual in read_fastx(input_path, stream=True):
        if len(seq) == 0:
            continue
        top = mt.search(label, seq)
        if top is None:
            pending.append((label, seq))
            if len(pending) >= mt.max_pending:
                _process_pending(pending, mt.search, mt.admit, f_uc)
        else:
            if f_uc:
                f_uc.write(_uc_hit_line(top, label))
    _process_pending(pending, mt.search, mt.admit, f_uc)

    if f_uc:
        f_uc.close()
    mt.write_centroids()


def _process_pending(pending, search_one, admit, f_uc) -> None:
    """ProcessPending (src/clustermt.cpp:46-78): serial re-search of
    buffered misses against the (growing) centroid set."""
    for label, seq in pending:
        top = search_one(label, seq)
        if top is None:
            ci = admit(label, seq)
            if f_uc:
                f_uc.write(f"S\t{ci}\t{len(seq)}\t*\t.\t*\t*\t*\t{label}\t*\n")
        else:
            if f_uc:
                f_uc.write(_uc_hit_line(top, label))
    pending.clear()


def _cluster_member_labels(state: ClusterState, dr: Optional[DerepResult],
                           ci: int) -> List[str]:
    """ClusterSink::GetLabels via GetClusterMembers
    (src/clustersink.cpp:511-543): member uniques in unique-index order
    with the centroid's unique forced first, each expanded into its derep
    input members."""
    centroid_ui = state.cluster_to_centroid_seq[ci]
    uis = [ui for ui in sorted(state.seq_to_cluster)
           if state.seq_to_cluster[ui] == ci]
    ordered = [centroid_ui]
    for k, ui in enumerate(uis):
        if k == 0:
            continue
        ordered.append(uis[0] if ui == centroid_ui else ui)
    labels: List[str] = []
    for ui in ordered:
        if dr is not None:
            for si in dr.members[ui]:
                labels.append(dr.input_db.labels[si])
        else:
            labels.append(state.unique_db.labels[ui])
    return labels


def _cons_tax(labels: List[str]) -> str:
    """ConsTaxStr::FromLabels (src/constaxstr.cpp:69-82)."""
    from ..amplicon.sintax import get_tax_str
    names: List[str] = []
    for label in labels:
        s = get_tax_str(label)
        if not s:
            continue
        parts = s.split(",")
        if not names:
            names = parts
            continue
        n = min(len(parts), len(names))
        for i in range(n):
            if names[i] != parts[i]:
                for j in range(i, n):
                    names[j] = "*"
                break
    out = []
    for nm in names:
        if nm == "*":
            break
        out.append(nm)
    return ",".join(out)


def _write_constax_report(path: str, state: ClusterState,
                          dr: Optional[DerepResult],
                          unique_db: SeqDB) -> None:
    """ClusterSink::WriteConsTaxReport (src/clustersink.cpp:178-216)."""
    from ..amplicon.sintax import get_tax_str
    o = options()
    n_clusters = len(state.cluster_sizes)
    order = list(range(n_clusters))
    if o.flag("sizeout"):
        order = quick_sort_order(state.cluster_sizes, desc=True)
    with open(path, "w") as f:
        for ci in order:
            labels = _cluster_member_labels(state, dr, ci)
            f.write(f"\nCluster {ci}, {len(labels)} members, centroid >"
                    f"{state.centroid_labels[ci]}\n")
            counts = {}
            for i, label in enumerate(labels):
                f.write(f" [{i:7d}] >{label}\n")
                s = get_tax_str(label)
                n = size_from_label(label, -1) if o.flag("sizein") else 1
                counts[s] = counts.get(s, 0) + n
            f.write("\n")
            for s in sorted(counts):
                f.write(f"  {counts[s]:5d}x  {s}\n")
            f.write(f"   Cons:  {_cons_tax(labels)}\n")
