"""Run-summary notes for -log (SURVEY §5.5).

Commands append structured notes (memory estimates, throughput) during
the run; the CLI writes them into the -log footer, mirroring the
reference's LogMemUsage / size-histogram / throughput lines
(src/udbdata.h:67-79, src/myutils.cpp:1451)."""

from __future__ import annotations

from typing import List

_notes: List[str] = []


def reset() -> None:
    _notes.clear()


def note(line: str) -> None:
    _notes.append(line)


def note_index(index) -> None:
    """UDBData::GetMemBytes-style summary for a posting index."""
    try:
        p = index.postings
        s = index.sizes
        nz = int((s > 0).sum())
        note(f"UDB index: {index.seq_count} seqs, {len(p)} postings "
             f"({p.nbytes + index.starts.nbytes >> 20} Mb), "
             f"{nz}/{len(s)} slots used, max row {int(s.max()) if len(s) else 0}")
    except Exception:
        pass


def note_throughput(label: str, n: int, secs: float) -> None:
    if secs > 0:
        note(f"{label}: {n} in {secs:.2f}s ({n / secs:.1f}/s)")


def drain() -> List[str]:
    out = list(_notes)
    _notes.clear()
    return out
