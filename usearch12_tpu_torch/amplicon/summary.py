"""sintax_summary / fastx_get_sample_names (src/sintaxsummary.cpp,
src/fastxgetsamplenames.cpp)."""

from __future__ import annotations

from typing import Optional

from ..config import options
from ..io.seqdb import size_from_label
from ..io.fastx import read_fastx
from ..search.hitmgr import quick_sort_order

_RANK_NAMES = {
    "d": "domain", "k": "kingdom", "p": "phylum", "c": "class",
    "o": "order", "f": "family", "g": "genus", "s": "species",
}


def _iter_labels(input_path):
    """Label-only fastx scan (sequences are never needed here).
    FASTA skips zero-length records like the reference SeqSource;
    FASTQ yields every record."""
    from ..io.fastx import open_maybe_gz, sniff_format, _proc_label
    fmt = sniff_format(input_path)
    with open_maybe_gz(input_path) as f:
        raw = f.read()
    lines = raw.split(b"\n")
    if fmt == "fasta":
        pending = None
        has_seq = False
        for line in lines:
            line = line.rstrip(b"\r")
            if line.startswith(b">"):
                if pending is not None and has_seq:
                    yield pending
                pending = _proc_label(line[1:])
                has_seq = False
            elif line:
                has_seq = True
        if pending is not None and has_seq:
            yield pending
    elif fmt == "fastq":
        i = 0
        n = len(lines)
        while i < n:
            line = lines[i].rstrip(b"\r")
            if not line:
                i += 1
                continue
            yield _proc_label(line[1:], fastq=True)
            i += 4
    else:
        for label, _seq, _q in read_fastx(input_path, stream=True):
            yield label


def fastx_get_sample_names(input_path: Optional[str]) -> None:
    from .otutab import sample_name_from_label
    o = options()
    samples = set()
    seen_labels = set()
    for label in _iter_labels(input_path):
        if label in seen_labels:
            continue       # identical label => identical sample name
        seen_labels.add(label)
        s = sample_name_from_label(label)
        if not s:
            raise SystemExit("Empty sample name")
        samples.add(s)
    with open(o.str("output"), "w") as f:
        for s in sorted(samples):
            f.write(s + "\n")


def sintax_summary(input_path: Optional[str]) -> None:
    o = options()
    if not o.filled("rank"):
        raise SystemExit("-rank required")
    rank = o.str("rank")
    if len(rank) != 1:
        raise SystemExit("-rank must be one letter")

    count_map = {}
    label_to_name = {}
    total_size = 0
    with open(input_path) as f:
        for line_nr, line in enumerate(f, 1):
            fields = line.rstrip("\n").split("\t")
            if len(fields) == 3:
                fields.append("")
            if len(fields) < 4:
                raise SystemExit(f"Line {line_nr}, too few fields")
            query_label = fields[0]
            size = size_from_label(query_label, 1)
            name = "(Unassigned)"
            path = fields[3]
            if path:
                for s in path.split(","):
                    if len(s) < 2 or s[1] != ":":
                        raise SystemExit(
                            f"Line {line_nr}, invalid taxonomy {path}")
                    if s[0] == rank:
                        name = s[2:]
                        break
            label_to_name[query_label] = name
            count_map[name] = count_map.get(name, 0) + size
            total_size += size

    # CountMapToVecs: map (lexicographic) order + quicksort desc
    keys = sorted(count_map.keys())
    counts = [count_map[k] for k in keys]
    order = quick_sort_order(counts, desc=True)
    names_vec = [keys[i] for i in order]
    count_vec = [counts[i] for i in order]

    out = o.str("output")
    with open(out, "w") as f:
        if not o.filled("otutabin"):
            sum_pct = 0.0
            for name, count in zip(names_vec, count_vec):
                pct = 100.0 * count / total_size if total_size else 0.0
                sum_pct += pct
                f.write(f"{name}\t{count}\t{pct:.1f}\t{sum_pct:.1f}\n")
        else:
            from .otutab import OTUTable
            ot = _read_otutab(o.str("otutabin"))
            rank_name = _RANK_NAMES.get(rank, rank).capitalize()
            f.write(rank_name)
            for s in ot.sample_names:
                f.write("\t" + s)
            f.write("\tAll\n")
            for name, count in zip(names_vec, count_vec):
                pct = 100.0 * count / total_size if total_size else 0.0
                f.write(name)
                for si in range(len(ot.sample_names)):
                    sum_name = 0
                    sum_all = 0
                    for oi, otu in enumerate(ot.otu_names):
                        c = ot.counts.get((oi, si), 0)
                        if otu not in label_to_name:
                            raise SystemExit(
                                f"OTU '{otu}' not found in sintax file")
                        sum_all += c
                        if label_to_name[otu] == name:
                            sum_name += c
                    p = 100.0 * sum_name / sum_all if sum_all else 0.0
                    f.write("\t%.3g" % p)
                f.write("\t%.1f\n" % pct)


def _read_otutab(path: str):
    from .otutab import OTUTable
    ot = OTUTable()
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        ot.sample_names = header[1:]
        ot._sample_idx = {s: i for i, s in enumerate(ot.sample_names)}
        for line in f:
            fields = line.rstrip("\n").split("\t")
            oi = len(ot.otu_names)
            ot.otu_names.append(fields[0])
            ot._otu_idx[fields[0]] = oi
            for si, v in enumerate(fields[1:]):
                if int(v):
                    ot.counts[(oi, si)] = int(v)
    return ot
