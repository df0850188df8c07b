"""Full-length exact dereplication (src/derepfull.cpp, src/derepresult.cpp).

Case-insensitive exact-sequence dedup preserving input order: uniques in
first-occurrence order, members per unique in input order (the reference's
single-thread hash-probe behaviour; its multi-thread merge reproduces the
same order).  Optional both-strand matching (SeqEqRC).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..alpha import TO_UPPER, revcomp
from ..config import options
from ..io.seqdb import SeqDB, size_from_label, strip_size


@dataclass
class DerepResult:
    input_db: SeqDB = None
    unique_seq_indexes: List[int] = field(default_factory=list)
    # per unique (by unique order): input seq indexes, unique itself first
    members: List[List[int]] = field(default_factory=list)
    # per member: True = plus strand match
    strands: List[List[bool]] = field(default_factory=list)
    # input seq index -> unique index
    cluster_of_input: Dict[int, int] = field(default_factory=dict)

    @property
    def cluster_count(self) -> int:
        return len(self.unique_seq_indexes)

    def member_count(self, unique_index: int) -> int:
        return len(self.members[unique_index])

    def seq_index(self, unique_index: int, member_index: int) -> int:
        return self.members[unique_index][member_index]

    def sum_size_in(self, unique_index: int) -> int:
        """GetSumSizeIn: sum of size= annotations over members
        (src/derepresult.cpp:211)."""
        total = 0
        for si in self.members[unique_index]:
            total += size_from_label(self.input_db.labels[si], 1)
        return total

    def to_seqdb(self) -> SeqDB:
        db = SeqDB()
        for ui, si in enumerate(self.unique_seq_indexes):
            db.add(self.input_db.labels[si], self.input_db.seqs[si],
                   self.input_db.quals[si])
        db.set_is_nucleo(self.input_db.get_is_nucleo())
        return db


def derep_full(input_db: SeqDB, revcomp_ok: bool = False) -> DerepResult:
    from .. import progress
    dr = DerepResult(input_db=input_db)
    if not revcomp_ok:
        out = _derep_native(input_db, dr)
        if out is not None:
            return out
    seen: Dict[bytes, int] = {}
    progress.start("Unique seqs")
    for si, seq in enumerate(input_db.seqs):
        progress.tick(si, len(input_db.seqs))
        key = TO_UPPER[seq].tobytes()
        ui = seen.get(key)
        plus = True
        if ui is None and revcomp_ok:
            rc_key = TO_UPPER[revcomp(seq)].tobytes()
            ui = seen.get(rc_key)
            plus = ui is None
        if ui is None:
            ui = len(dr.unique_seq_indexes)
            seen[key] = ui
            dr.unique_seq_indexes.append(si)
            dr.members.append([si])
            dr.strands.append([True])
        else:
            dr.members[ui].append(si)
            dr.strands[ui].append(plus)
        dr.cluster_of_input[si] = ui
    progress.done(f"{dr.cluster_count} uniques")
    return dr


class _LazyMembers:
    """members[u] -> input indexes of cluster u (input order), built
    from the stable argsort of cluster ids without materializing 100k
    Python lists."""

    def __init__(self, order, bounds) -> None:
        self._order = order
        self._bounds = bounds

    def __len__(self):
        return len(self._bounds) - 1

    def __getitem__(self, u):
        b = self._bounds
        return self._order[int(b[u]):int(b[u + 1])]


class _LazyStrands:
    """Plus-strand derep: every member matched forward."""

    def __init__(self, counts) -> None:
        self._counts = counts

    def __len__(self):
        return len(self._counts)

    def __getitem__(self, u):
        return [True] * int(self._counts[u])


def _derep_native(input_db: SeqDB, dr: DerepResult):
    """derep_full via derep_c (plus strand); numpy grouping for the
    member lists.  Returns None when the native lib is unavailable."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    from .. import progress
    import numpy as np
    from ..alpha import TO_UPPER
    n = len(input_db)
    if n == 0:
        return dr
    progress.start("Unique seqs")
    seqs = input_db.seqs
    bulk = getattr(input_db, "_bulk_buf", None)
    if bulk is not None and len(getattr(input_db, "_bulk_off", ())) \
            == n + 1:
        off0 = input_db._bulk_off
        cat = bulk[int(off0[0]):int(off0[n])]
        offs = off0 - off0[0]
        cat = cat if cat.flags["C_CONTIGUOUS"] \
            else np.ascontiguousarray(cat)
        offs = np.ascontiguousarray(offs)
    else:
        lens = np.fromiter((len(s) for s in seqs), np.int64, n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        cat = np.concatenate([np.ascontiguousarray(s) for s in seqs]) \
            if n else np.zeros(0, np.uint8)
    cl = np.empty(n, np.int32)
    tu = np.ascontiguousarray(TO_UPPER)
    nu = lib.derep_c(cat.ctypes.data, offs.ctypes.data, n,
                     tu.ctypes.data, cl.ctypes.data)
    # first-occurrence index per cluster (ids are assigned in
    # first-occurrence order, so return_index is already id-ordered)
    _u, first = np.unique(cl, return_index=True)
    dr.unique_seq_indexes = first.tolist()
    order = np.argsort(cl, kind="stable")
    counts = np.bincount(cl, minlength=nu)
    bounds = np.zeros(nu + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    dr.members = _LazyMembers(order, bounds)
    dr.strands = _LazyStrands(counts)
    dr.cluster_of_input = cl          # array indexable like the dict
    progress.done(f"{dr.cluster_count} uniques")
    return dr


def _uniques_emit_native(o, db, dr, order, member_counts,
                         relabel) -> bool:
    """fastaout via uniques_fasta_emit_c over the bulk seq buffer.
    Handles generated-relabel labels (with/without -sizeout) and plain
    label passthrough; Python handles sizeout-on-original-labels
    (strip_size rewriting) and non-bulk inputs."""
    from ..native import get_lib
    from ..io.seqdb import _LazyLabels
    lib = get_lib()
    bulk = getattr(db, "_bulk_buf", None)
    if (lib is None or bulk is None
            or len(getattr(db, "_bulk_off", ())) != len(db) + 1):
        return False
    sizeout = o.flag("sizeout")
    if sizeout and not relabel:
        return False        # strip_size on original labels: python path
    if relabel and (relabel.startswith(";") or relabel.endswith(";")):
        return False        # strip_size would rewrite the generated label
    if not relabel and not isinstance(db.labels, _LazyLabels):
        return False
    minuq = o.uns("minuniquesize", 0)
    topn = o.uns("topn") if o.filled("topn") else None
    mc = np.asarray(member_counts, np.int64)
    order_a = np.asarray(order, np.int64)
    sz_sorted = mc[order_a]
    n_sel = len(order_a)
    below = np.nonzero(sz_sorted < minuq)[0]
    if len(below):
        n_sel = int(below[0])   # descending order; reference breaks here
    if topn is not None:
        n_sel = min(n_sel, int(topn))
    sel_u = order_a[:n_sel]
    usi = np.asarray(dr.unique_seq_indexes, np.int64)
    sel = np.ascontiguousarray(usi[sel_u])
    sizes_sel = np.ascontiguousarray(sz_sorted[:n_sel])
    soff = np.ascontiguousarray(db._bulk_off, np.int64)
    cols = int(o.uns("fasta_cols"))
    if relabel:
        pfx = np.frombuffer(relabel.encode("latin1"), np.uint8)
        plen = len(pfx)
        lblbuf = lo = hi = None
        lbl_bytes = 0
    else:
        labels = db.labels
        lblbuf = np.frombuffer(labels.raw, np.uint8)
        lo = np.ascontiguousarray(labels.lo, np.int64)
        hi = np.ascontiguousarray(labels.hi, np.int64)
        pfx = np.zeros(1, np.uint8)
        plen = -1
        lbl_bytes = int((hi - lo).max() if len(lo) else 0) * n_sel
    seq_bytes = int((soff[1:] - soff[:-1])[sel].sum()) if n_sel else 0
    cap = (seq_bytes + seq_bytes // max(cols, 1) + 64 * n_sel
           + lbl_bytes + 1024)
    while True:
        out = np.empty(cap, np.uint8)
        ret = lib.uniques_fasta_emit_c(
            bulk.ctypes.data, soff.ctypes.data, sel.ctypes.data, n_sel,
            pfx.ctypes.data, plen,
            lblbuf.ctypes.data if lblbuf is not None else None,
            lo.ctypes.data if lo is not None else None,
            hi.ctypes.data if hi is not None else None,
            sizes_sel.ctypes.data, int(bool(sizeout and relabel)),
            cols, out.ctypes.data, cap)
        if ret >= 0:
            break
        cap *= 2
    with open(o.str("fastaout"), "wb") as f:
        f.write(out[:ret].tobytes())
    return True


def fastx_uniques(input_path: Optional[str]) -> None:
    """cmd_fastx_uniques: derep + sorted-by-size output
    (src/derepfull.cpp:233, src/derepresult.cpp Write/ToFastx)."""
    from ..config import options
    from ..io.fastx import write_fasta
    from ..io.seqdb import relabel_with_size
    from ..search.hitmgr import quick_sort_order

    o = options()
    db = SeqDB.from_fastx(input_path, lazy=True)
    strand_both = o.str("strand", "plus") == "both"
    dr = derep_full(db, revcomp_ok=strand_both)

    # DerepResult::SetSizes (src/derepresult.cpp:822-845): cluster size =
    # sum of member size= annotations with -sizein, else member count;
    # SetOrder sorts by THESE sizes, and the minuniquesize gate and the
    # size= output use them too
    bounds = getattr(dr.members, "_bounds", None)
    morder = getattr(dr.members, "_order", None)
    if o.flag("sizein"):
        if bounds is not None:
            from ..io.seqdb import sizes_bulk
            all_sz = sizes_bulk(db, len(db), 1)
            member_counts = np.add.reduceat(
                all_sz[morder], bounds[:-1]).tolist()                 if dr.cluster_count else []
        else:
            member_counts = [dr.sum_size_in(u)
                             for u in range(dr.cluster_count)]
    else:
        if bounds is not None:
            member_counts = (np.asarray(bounds[1:])
                             - np.asarray(bounds[:-1])).tolist()
        else:
            member_counts = [dr.member_count(u)
                             for u in range(dr.cluster_count)]
    order = quick_sort_order(member_counts, desc=True)

    relabel = o.str("relabel", "")
    if o.filled("fastaout") and _uniques_emit_native(
            o, db, dr, order, member_counts, relabel):
        pass
    elif o.filled("fastaout"):
        minuq = o.uns("minuniquesize", 0)
        topn = o.uns("topn") if o.filled("topn") else None
        sizeout = o.flag("sizeout")
        sizein = o.flag("sizein")
        cols = o.uns("fasta_cols")
        out = []
        with open(o.str("fastaout"), "w") as f:
            n_out = 0
            for u in order:
                size = member_counts[u]
                if size < minuq:
                    break  # order is descending; reference breaks here
                if topn is not None and n_out >= topn:
                    break
                si = dr.unique_seq_indexes[u]
                label = db.labels[si]
                if relabel:
                    n_out += 1
                    label = f"{relabel}{n_out}"
                if sizeout:
                    label = strip_size(label)
                    # member_counts already holds SumSizeIn with -sizein
                    label = relabel_with_size(label, size)
                if not relabel:
                    n_out += 1
                s = db.seqs[si].tobytes().decode("latin1")
                if cols <= 0:
                    out.append(f">{label}\n{s}\n")
                else:
                    body = "\n".join(s[i:i + cols]
                                     for i in range(0, len(s), cols))
                    out.append(f">{label}\n{body}\n" if s
                               else f">{label}\n\n")
            f.write("".join(out))
    if o.filled("tabbedout"):
        with open(o.str("tabbedout"), "w") as f:
            for u in range(dr.cluster_count):
                si = dr.unique_seq_indexes[u]
                for mi in dr.members[u]:
                    f.write(f"{db.labels[mi]}\t{db.labels[si]}\n")
    if o.filled("constax_report"):
        # DerepResult::WriteConsTaxReport (src/derepresult.cpp:796-809):
        # clusters in size-descending order (sum of size= with -sizein)
        from ..cluster.uclust import _cons_tax
        from ..amplicon.sintax import get_tax_str
        sizes = [dr.sum_size_in(u) if o.flag("sizein") else member_counts[u]
                 for u in range(dr.cluster_count)]
        ct_order = quick_sort_order(sizes, desc=True)
        with open(o.str("constax_report"), "w") as f:
            for u in ct_order:
                labels = [db.labels[mi] for mi in dr.members[u]]
                cent = db.labels[dr.unique_seq_indexes[u]]
                f.write(f"\nCluster {u}, {len(labels)} members, centroid >"
                        f"{cent}\n")
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
    if o.filled("uc"):
        with open(o.str("uc"), "w") as f:
            for u in range(dr.cluster_count):
                si = dr.unique_seq_indexes[u]
                L = len(db.seqs[si])
                f.write(f"S\t{u}\t{L}\t*\t*\t*\t*\t*\t{db.labels[si]}\t*\n")
                for mi in dr.members[u][1:]:
                    f.write(f"H\t{u}\t{L}\t100.0\t*\t*\t*\t*\t"
                            f"{db.labels[mi]}\t{db.labels[si]}\n")
            for u in range(dr.cluster_count):
                si = dr.unique_seq_indexes[u]
                f.write(f"C\t{u}\t{dr.member_count(u)}\t*\t*\t*\t*\t*\t"
                        f"{db.labels[si]}\t*\n")
