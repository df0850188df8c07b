"""OTU table construction (src/otutabsink.cpp, src/otutab.cpp).

-otutab: global search of reads vs OTU reference; each read's top hit adds
its size to cell (OTU name of target, sample name of query).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..config import options
from ..io.seqdb import SeqDB, size_from_label


def get_str_field(label: str, name_eq: str) -> str:
    for field in label.split(";"):
        if field.startswith(name_eq):
            return field[len(name_eq):]
    return ""


def otu_name_from_label(label: str) -> str:
    """GetOTUNameFromLabel (src/label.cpp:193-202)."""
    from .uchime import acc_from_label
    name = get_str_field(label, "otu=")
    if name:
        return name
    name = acc_from_label(label)
    if not name:
        raise SystemExit(f"Empty OTU name in label >{label}")
    return name


_SAMPLE_LEAD_RE = None


def sample_name_from_label(label: str) -> str:
    """GetSampleNameFromLabel (src/label.cpp:204-233).  The leading-run
    scan uses C isalpha/isdigit (ASCII), hence the explicit class."""
    o = options()
    if "sample=" in label:
        name = get_str_field(label, "sample=")
        if name:
            return name
    if "barcodelabel=" in label:
        name = get_str_field(label, "barcodelabel=")
        if name:
            return name
    if o.filled("sample_delim"):
        d = o.str("sample_delim")
        n = label.find(d)
        if n < 0:
            raise SystemExit(f"delim '{d}' not found in >{label}")
        return label[:n]
    global _SAMPLE_LEAD_RE
    if _SAMPLE_LEAD_RE is None:
        import re
        _SAMPLE_LEAD_RE = re.compile(r"[A-Za-z0-9_]*")
    return _SAMPLE_LEAD_RE.match(label).group(0)


class OTUTable:
    def __init__(self) -> None:
        self.otu_names: List[str] = []
        self.sample_names: List[str] = []
        self._otu_idx: Dict[str, int] = {}
        self._sample_idx: Dict[str, int] = {}
        self.counts: Dict[tuple, int] = {}

    def inc(self, otu: str, sample: str, size: int) -> None:
        oi = self._otu_idx.setdefault(otu, len(self.otu_names))
        if oi == len(self.otu_names):
            self.otu_names.append(otu)
        si = self._sample_idx.setdefault(sample, len(self.sample_names))
        if si == len(self.sample_names):
            self.sample_names.append(sample)
        self.counts[(oi, si)] = self.counts.get((oi, si), 0) + size

    def to_tabbed(self, path: str) -> None:
        ns = len(self.sample_names)
        with open(path, "w") as f:
            f.write("#OTU ID")
            if ns:
                f.write("\t" + "\t".join(self.sample_names))
            f.write("\n")
            # counts are sparse: patch a zero row template per OTU
            # instead of a dict lookup per cell
            by_row: List[list] = [[] for _ in self.otu_names]
            for (oi, si), v in self.counts.items():
                by_row[oi].append((si, v))
            parts = ["0"] * ns
            for oi, otu in enumerate(self.otu_names):
                if ns == 0:
                    f.write(otu + "\n")
                    continue
                row = by_row[oi]
                for si, v in row:
                    parts[si] = str(v)
                f.write(otu + "\t" + "\t".join(parts) + "\n")
                for si, _v in row:
                    parts[si] = "0"


def otutab(query_path: Optional[str]) -> None:
    from ..search.driver import search_file
    from ..search.hitmgr import HitMgr
    o = options()
    from ..index.udbfile import load_db
    # DB filename from -db, -otus or -zotus (src/searchcmd.cpp:29-37)
    if o.filled("db"):
        db_path = o.str("db")
    elif o.filled("otus"):
        db_path = o.str("otus")
    elif o.filled("zotus"):
        db_path = o.str("zotus")
    else:
        raise SystemExit("Must specify OTU FASTA -db, -otus or -zotus")
    db, db_index = load_db(db_path)
    table = OTUTable()
    # OTUTableSink (and its -mapout file) only exists when a table
    # output was requested (src/makedbsearcher.cpp:217-219)
    f_map = open(o.str("mapout"), "w") \
        if o.filled("mapout") and (o.filled("otutabout")
                                   or o.filled("biomout")) else None
    f_uc = open(o.str("uc"), "w") if o.filled("uc") else None
    f_b6 = open(o.str("blast6out"), "w") if o.filled("blast6out") else None

    def on_query_done(label, seq, hits):
        hm = HitMgr()
        hm.hits = hits
        if f_uc or f_b6:
            from ..out import uc as uc_mod
            from ..out.blast6 import blast6_line
            ordered = hm.sorted_hits()
            for ar in ordered:
                if f_uc:
                    f_uc.write(uc_mod.uc_hit_record(ar))
                if f_b6:
                    f_b6.write(blast6_line(ar))
            if not ordered and f_uc:
                f_uc.write(uc_mod.uc_no_hit_record(label, len(seq)))
        if not hits:
            return
        top = hm.top_hit()
        otu = otu_name_from_label(top.target_label)
        sample = sample_name_from_label(label)
        size = size_from_label(label, 1)
        table.inc(otu, sample, size)
        if f_map:
            f_map.write(f"{label}\t{otu}\n")

    search_file("otutab", query_path, db, on_query_done)
    for fh in (f_map, f_uc, f_b6):
        if fh:
            fh.close()
    if o.filled("otutabout"):
        table.to_tabbed(o.str("otutabout"))
    if o.filled("biomout"):
        _to_biom(table, o.str("biomout"))


def _to_biom(table: OTUTable, path: str) -> None:
    """BIOM JSON byte-matching OTUTable::ToJsonFile (src/json.cpp:32-104)
    except the run-time "date" field."""
    import time
    no = len(table.otu_names)
    ns = len(table.sample_names)
    with open(path, "w") as f:
        f.write("{\n")
        f.write(f'\t"id":"{path}",\n')
        f.write('\t"format": "Biological Observation Matrix 1.0",\n')
        f.write('\t"format_url": "http://biom-format.org",\n')
        f.write('\t"generated_by": "usearch",\n')
        f.write('\t"type": "OTU table",\n')
        f.write(f'\t"date": "{time.asctime()[:24]}",\n')
        f.write('\t"matrix_type": "sparse",\n')
        f.write('\t"matrix_element_type": "float",\n')
        f.write(f'\t"shape": [{no},{ns}],\n')
        f.write('\t"rows":[\n')
        for oi, n in enumerate(table.otu_names):
            f.write('\t\t{"id":"%s", "metadata":null}%s\n'
                    % (n, "," if oi + 1 != no else ""))
        f.write("\t],\n")
        f.write('\t"columns":[\n')
        for si, n in enumerate(table.sample_names):
            f.write('\t\t{"id":"%s", "metadata":null}%s\n'
                    % (n, "," if si + 1 != ns else ""))
        f.write("\t],\n")
        f.write('\t"data": [\n')
        # sparse cells in (OTU, sample) scan order; trailing-comma rule
        # follows the reference's per-cell index test
        for oi in range(no):
            for si in range(ns):
                c = table.counts.get((oi, si), 0)
                if c == 0:
                    continue
                sep = "," if (oi + 1 < no or si + 1 < ns) else ""
                f.write(f"\t\t[{oi},{si},{c}]{sep}\n")
        f.write("\t]\n")
        f.write("}\n")


def closed_ref(query_path: Optional[str]) -> None:
    """closed_ref: like otutab but emits matched-OTU centroids and table
    (src/closedrefsink.cpp).  Minimal implementation: otutab semantics with
    CMD closed_ref terminator defaults."""
    from ..search.driver import search_file
    from ..search.hitmgr import HitMgr
    from ..io.fastx import write_fasta
    o = options()
    from ..index.udbfile import load_db
    db, db_index = load_db(o.str("db"))
    table = OTUTable()
    matched_targets = {}

    def on_query_done(label, seq, hits):
        if not hits:
            return
        hm = HitMgr()
        hm.hits = hits
        top = hm.top_hit()
        otu = otu_name_from_label(top.target_label)
        sample = sample_name_from_label(label)
        size = size_from_label(label, 1)
        table.inc(otu, sample, size)
        matched_targets.setdefault(top.target_index, top.target_label)

    search_file("closed_ref", query_path, db, on_query_done)
    if o.filled("otutabout"):
        table.to_tabbed(o.str("otutabout"))
    if o.filled("otus"):
        with open(o.str("otus"), "w") as f:
            for tix in sorted(matched_targets):
                write_fasta(f, db.labels[tix], db.seqs[tix],
                            o.uns("fasta_cols"))
