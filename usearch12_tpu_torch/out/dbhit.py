"""DBHitSink: per-target hit coverage -> -dbmatched/-dbnotmatched/-dbcutout
(src/dbhitsink.{h,cpp})."""

from __future__ import annotations

from typing import List

from ..config import options
from ..io.seqdb import SeqDB, size_from_label, relabel_with_size
from ..io.fastx import write_fasta


class DBHitSink:
    def __init__(self, db: SeqDB) -> None:
        self.db = db
        n = len(db)
        self.hit_counts = [0] * n
        o = options()
        self.cutout = o.filled("dbcutout")
        self.los: List[List[int]] = [[] for _ in range(n)] \
            if self.cutout else []
        self.his: List[List[int]] = [[] for _ in range(n)] \
            if self.cutout else []

    def on_query_done(self, query_label: str, ordered_hits, cmd: str
                      ) -> None:
        """OnQueryDone (src/dbhitsink.cpp:130-163): counts per target,
        weighted by size= with -sizein; otutab counts only the top hit."""
        if not ordered_hits:
            return
        o = options()
        hits = ordered_hits
        if cmd == "otutab" and len(hits) > 1:
            hits = hits[:1]
        for ar in hits:
            tix = ar.target_index
            n = size_from_label(query_label, 1) if o.flag("sizein") else 1
            self.hit_counts[tix] += n
            if self.cutout:
                ar._fill()
                for _ in range(n):
                    self.los[tix].append(ar.first_m_tpos)
                    self.his[tix].append(ar.last_m_tpos)

    def on_all_done(self) -> None:
        o = options()
        if o.filled("dbmatched"):
            self._to_fasta(o.str("dbmatched"), matched=True)
        if o.filled("dbnotmatched"):
            self._to_fasta(o.str("dbnotmatched"), matched=False)
        if o.filled("dbcutout"):
            self._cut_to_fasta(o.str("dbcutout"))

    def _to_fasta(self, path: str, matched: bool) -> None:
        o = options()
        cols = o.uns("fasta_cols")
        with open(path, "w") as f:
            for i in range(len(self.db)):
                n = self.hit_counts[i]
                if matched != (n > 0):
                    continue
                label = self.db.labels[i]
                if o.flag("sizeout") and matched:
                    label = relabel_with_size(label, n)
                write_fasta(f, label, self.db.seqs[i], cols)

    def _cut_to_fasta(self, path: str) -> None:
        """Median hit segment per target (src/dbhitsink.cpp:62-100)."""
        cols = options().uns("fasta_cols")
        with open(path, "w") as f:
            for i in range(len(self.db)):
                if self.hit_counts[i] == 0:
                    continue
                los = sorted(self.los[i])
                his = sorted(self.his[i])
                lo = los[len(los) // 2]
                hi = his[len(his) // 2]
                write_fasta(f, self.db.labels[i],
                            self.db.seqs[i][lo:hi + 1], cols)
