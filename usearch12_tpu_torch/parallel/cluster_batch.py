"""cluster_mt with its word counting on the card (-mesh).

Port of usearch12_tpu/parallel/cluster_batch.py.  Queries stream against
a FROZEN centroid set; misses buffer as pending; at the flush they are
searched again one by one with admissions applied in input order
(src/clustermt.cpp:46-123).  Between flushes the centroid set is
immutable, so each window of queries gets its shared-unique-word counts
U = Q @ W^T in one int8 product (parallel/incidence.py) against the
centroids' incidence, whose rows are sharded over the mesh's "db" axis and
whose query rows split over its "data" axis.  The U rows come back to the
host, where the reference's SetTopBump and count sort order the
candidates, and the host's aligner (cluster/uclust.py:MtCentroids) takes
them: the -uc and -centroids bytes are those of the host cluster_mt.

Above -big centroids the reference ranks with UDBSearchBig (stepped
words, first-touch order; search/usorted.py), which the counts do not
give: such windows are ranked by the host ranker, as the host cluster_mt
ranks them, and counted in the run's stats (`host_ranked`).  The JAX
package ranks them with SetTopBump and so writes other bytes there.

-checkpoint FILE saves the run after every flush (queries consumed, the
centroids, the -uc bytes written); a run started with an existing FILE
resumes from it and writes the bytes of an uninterrupted run.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..cluster.uclust import MtCentroids, _uc_hit_line
from ..config import options
from ..index.udb import UDBIndex
from ..io.fastx import read_fastx
from ..search.usorted import (count_sort_order_desc, quick_sort_order_desc,
                              set_top_bump, set_top_no_bump)
from . import incidence
from .mesh import Mesh


class DeviceUCounter:
    """U counting for a query window against the frozen centroid index:
    one int8 product a shard, over the mesh's devices.

    Admissions between flushes write their incidence rows in place: the
    incidence has a geometric row capacity (padded to 8 rows a shard), and
    the rows of new centroids are copied into the live shards, so a flush
    costs O(V * new centroids), not a rebuild of O(V * capacity)."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self._w = None       # {(device, shard): (cap / n_db, V_pad) int8}
        self._t = 0          # rows filled
        self._cap = 0        # row capacity
        self._pending_rows = None
        dev0 = mesh.devices[0, 0]
        self._timed = dev0.type == "cuda" and all(
            d == dev0 for d in mesh.devices.flat)
        self.stats = {"windows": 0, "count_ms": 0.0 if self._timed else None,
                      "allocs": 0}

    @property
    def cap(self) -> int:
        return self._cap

    @property
    def nbytes(self) -> int:
        """Bytes of the incidence on the devices (each distinct copy)."""
        return sum(w.numel() for w in (self._w or {}).values())

    def _shard_of(self, i: int, j: int) -> torch.Tensor:
        return self._w[(self.mesh.devices[i, j], j)]

    def _alloc(self, index: UDBIndex, cap: int) -> None:
        """(Re)build the incidence with row capacity cap."""
        n_db = self.mesh.shape["db"]
        cap += (-cap) % (8 * n_db)
        s = cap // n_db
        self._w = incidence.shards(
            index, self.mesh, s, incidence.pad8(index.params.slot_count))
        self._cap = cap
        self._t = index.seq_count
        self._pending_rows = None
        self.stats["allocs"] += 1

    def refresh(self, index: UDBIndex) -> None:
        """Bring the incidence up to date with the index: writes the rows
        of new centroids in place, growing the capacity geometrically."""
        t = index.seq_count
        if t == 0:
            self._w = None
            self._t = 0
            self._cap = 0
            return
        if self._w is None or t > self._cap or t < self._t:
            self._alloc(index, max(2 * t, 1024))
            return
        if t == self._t:
            return
        rows = self._pending_rows
        assert rows is not None and rows.shape[0] == t - self._t, \
            "refresh without note_admitted for the new centroids"
        s = self._cap // self.mesh.shape["db"]
        for (dev, j), w in self._w.items():
            lo, hi = max(self._t, j * s), min(t, (j + 1) * s)
            if lo < hi:
                w[lo - j * s:hi - j * s].copy_(
                    torch.from_numpy(rows[lo - self._t:hi - self._t]))
        self._pending_rows = None
        self._t = t

    def note_admitted(self, index: UDBIndex, seqs) -> None:
        """Record the just-admitted centroid sequences so refresh() can
        write their incidence rows without reading the index's postings."""
        v_pad = incidence.pad8(index.params.slot_count)
        rows = np.zeros((len(seqs), v_pad), dtype=np.int8)
        for k, s in enumerate(seqs):
            w = index.params.unique_words(s)
            np.add.at(rows, (np.full(len(w), k), w), 1)
        if self._pending_rows is None:
            self._pending_rows = rows
        else:
            self._pending_rows = np.concatenate([self._pending_rows, rows])

    def count(self, index: UDBIndex, seqs: List[np.ndarray]) -> np.ndarray:
        """(B, T) uint32 shared-unique-word counts of the queries against
        the T centroids."""
        t = self._t
        if t == 0:
            return np.zeros((len(seqs), 0), np.uint32)
        mesh = self.mesh
        n_data, n_db = mesh.shape["data"], mesh.shape["db"]
        s = self._cap // n_db
        v_pad = incidence.pad8(index.params.slot_count)
        words = [index.params.unique_words(x) for x in seqs]
        out = np.zeros((len(seqs), t), np.uint32)
        per = -(-len(seqs) // n_data)
        if self._timed:
            stream = torch.cuda.current_stream(mesh.devices[0, 0])
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        parts = []
        for i in range(n_data):
            lo, hi = i * per, min((i + 1) * per, len(seqs))
            if lo >= hi:
                continue
            rows = incidence.query_rows(hi - lo)
            q = {}
            for j in range(n_db):
                # only the filled rows of the shard (to a multiple of 8)
                n_j = min(s, incidence.pad8(max(t - j * s, 0)))
                if n_j == 0:
                    continue
                dev = mesh.devices[i, j]
                if dev not in q:
                    q[dev] = incidence.onehot(words[lo:hi], rows, v_pad, dev)
                u = incidence.int8_mm(q[dev], self._shard_of(i, j)[:n_j])
                m = min(n_j, t - j * s)
                parts.append((lo, hi, j * s, m, u[:hi - lo, :m]))
        if self._timed:
            ev[1].record(stream)
        for lo, hi, c0, m, u in parts:
            out[lo:hi, c0:c0 + m] = u.cpu().numpy()
        if self._timed:
            self.stats["count_ms"] += ev[0].elapsed_time(ev[1])
        self.stats["windows"] += 1
        return out


def _rank_from_u(u: np.ndarray):
    """Exact host replay of USortedRanker.rank given a precomputed U row
    (src/udbusortedsearcher.cpp SetTop/SortTop order)."""
    o = options()
    bump = o.uns("bump")
    if bump != 0:
        top_u, top_tix = set_top_bump(u, 1, bump)
    else:
        top_u, top_tix = set_top_no_bump(u, 1)
    if o.flag("quicksort"):
        order = quick_sort_order_desc(top_u)
    else:
        order = count_sort_order_desc(top_u)
    return top_tix[order]


def _save_checkpoint(path: str, pos: int, f_uc, labels, seqs) -> None:
    """The run's state after a flush: the queries consumed, the -uc bytes
    written, the centroids (the JAX package's .npz fields)."""
    off = 0
    if f_uc is not None:
        f_uc.flush()
        off = f_uc.tell()
    np.savez(path + ".tmp.npz", pos=pos, uc_offset=off,
             labels=np.array(labels, dtype=object),
             seqs=np.array(seqs, dtype=object))
    os.replace(path + ".tmp.npz", path)


def cluster_mt_batched(input_path: Optional[str], mesh: Mesh) -> dict:
    """cluster_mt with the U counting on the mesh's devices; writes the
    host cluster_mt's bytes.  Returns the run's stats (also appended as a
    JSON line to $USEARCH_DEVICE_STATS when that is set)."""
    o = options()
    mt = MtCentroids(input_path)
    index = mt.index
    counter = DeviceUCounter(mesh)
    big = o.uns("big")
    stats = {"cluster_mt_batched": True, "queries": 0, "flushes": 0,
             "host_ranked": 0}
    records = [(label, seq) for label, seq, _q
               in read_fastx(input_path, stream=True) if len(seq) > 0]
    pending: List = []
    pos = 0
    window = mt.max_pending

    # -checkpoint: the batch-synchronous round is the natural checkpoint
    # unit -- after every flush the whole state is (queries consumed,
    # centroid set, -uc bytes written)
    ckpt_path = o.str("checkpoint") if o.filled("checkpoint") else None
    f_uc = None
    if ckpt_path is not None and os.path.exists(ckpt_path):
        data = np.load(ckpt_path, allow_pickle=True)
        pos = int(data["pos"])
        for lbl, s in zip(list(data["labels"]), list(data["seqs"])):
            mt.admit(str(lbl), np.asarray(s, dtype=np.uint8))
        if o.filled("uc"):
            # keep the records of the checkpoint, drop those written after
            # it; a missing file resumes as an empty one
            with open(o.str("uc"), "a+b") as fh:
                fh.truncate(int(data["uc_offset"]))
            f_uc = open(o.str("uc"), "a")
    elif o.filled("uc"):
        f_uc = open(o.str("uc"), "w")

    def flush():
        """ProcessPending (src/clustermt.cpp:46-78), on the host ranker."""
        admitted = []
        for label, seq in pending:
            top = mt.search(label, seq)
            if top is None:
                ci = mt.admit(label, seq)
                admitted.append(seq)
                if f_uc:
                    f_uc.write(f"S\t{ci}\t{len(seq)}\t*\t.\t*\t*\t*\t"
                               f"{label}\t*\n")
            elif f_uc:
                f_uc.write(_uc_hit_line(top, label))
        pending.clear()
        stats["flushes"] += 1
        if index.seq_count <= big:
            if admitted:
                counter.note_admitted(index, admitted)
            counter.refresh(index)

    try:
        counter.refresh(index)
        while pos < len(records):
            batch = records[pos:pos + window]
            host = index.seq_count > big
            u_rows = None if host else counter.count(
                index, [s for _l, s in batch])
            flushed = False
            for b, (label, seq) in enumerate(batch):
                stats["queries"] += 1
                if host:
                    stats["host_ranked"] += 1
                    top = mt.search(label, seq)
                else:
                    top = mt.search(label, seq, _rank_from_u(u_rows[b])
                                    if u_rows.shape[1] else [])
                if top is None:
                    pending.append((label, seq))
                    if len(pending) >= mt.max_pending:
                        # admissions change the frozen set: flush, then
                        # window again from the next query
                        flush()
                        pos += b + 1
                        if ckpt_path is not None:
                            _save_checkpoint(ckpt_path, pos, f_uc,
                                             mt.labels, mt.seqs)
                        flushed = True
                        break
                elif f_uc:
                    f_uc.write(_uc_hit_line(top, label))
            if not flushed:
                pos += len(batch)
        flush()
    finally:
        if f_uc:
            f_uc.close()
    mt.write_centroids()
    stats.update(centroids=index.seq_count, cap=counter.cap,
                 incidence_bytes=counter.nbytes, **counter.stats)
    path = os.environ.get("USEARCH_DEVICE_STATS")
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(stats) + "\n")
    return stats
