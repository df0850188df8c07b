"""FASTA/FASTQ streaming readers and writers (+transparent gzip).

Host-side I/O layer standing in for the reference's SeqSource/LineReader
stack (src/seqsource.cpp, src/linereader.cpp, src/gzipfileio.cpp).  Python's
gzip replaces the vendored zlib.  Readers yield (label, seq_bytes, qual_str)
tuples; seq is np.uint8 ASCII.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, Optional, Tuple

import numpy as np

Record = Tuple[str, np.ndarray, Optional[str]]


def open_maybe_gz(path: str, mode: str = "rb"):
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
    except OSError as e:
        raise SystemExit(f"Cannot open {path}: {e.strerror}")
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


def sniff_format(path: str) -> str:
    """'fasta' | 'fastq' | 'udb' | 'empty' by content (src/filetype.cpp)."""
    with open_maybe_gz(path) as f:
        head = f.read(16)
    if not head:
        return "empty"
    if head[:1] == b">":
        return "fasta"
    if head[:1] == b"@":
        return "fastq"
    if head[:8] == UDB_MAGIC8:
        return "udb"
    raise ValueError(f"unrecognized file format: {path}")


# .udb file magic (src/udbfile.h); checked here for dispatch only
UDB_MAGIC8 = (0x55444246).to_bytes(4, "little") + (0x55444246).to_bytes(4, "little")


_ALPHA = frozenset(range(65, 91)) | frozenset(range(97, 123))
_SPACE = frozenset(b" \t\v\f\r\n")


def _seq_delete_table(stream: bool) -> bytes:
    """Bytes removed from FASTA sequence lines (FastaSeqSource::GetNextLo,
    src/fastaseqsource.cpp:80-111): whitespace always, '-'/'.' unless
    -keepgaps, and any other non-alpha byte (BadByte).  -keepgaps is only
    honored on streaming readers; SeqDB::FromFastx overrides StripGaps=true
    (src/seqdbfromfasta.cpp:24-41, seqdb.h:148)."""
    from ..config import options
    keepgaps = stream and options().flag("keepgaps")
    drop = []
    for c in range(256):
        if c in _ALPHA:
            continue
        if c in (ord("-"), ord(".")) and keepgaps:
            continue
        drop.append(c)
    return bytes(drop)


def _proc_label(raw: bytes, fastq: bool = False) -> str:
    """-trunclabels (first whitespace) and, for FASTA, -truncstr
    (src/fastaseqsource.cpp:58-78, src/fastqseqsource.cpp:52-63)."""
    from ..config import options
    o = options()
    label = raw.decode("latin1")
    if o.flag("trunclabels"):
        for i, ch in enumerate(label):
            if ch in " \t\v\f":
                label = label[:i]
                break
    if not fastq and o.filled("truncstr"):
        n = label.find(o.str("truncstr"))
        if n >= 0:
            label = label[:n]
    return label


def _warn_empty(label: str) -> None:
    """The reference silently skips zero-length records
    (src/fastaseqsource.cpp:31); we additionally warn so discarded
    records leave a trace (suppressed under -quiet)."""
    from ..config import options
    if not options().flag("quiet"):
        import sys
        print(f"WARNING: Ignoring zero-length sequence '{label}'",
              file=sys.stderr)


def read_fasta(path: str, stream: bool = False) -> Iterator[Record]:
    label = None
    chunks = []
    delete = _seq_delete_table(stream)
    with open_maybe_gz(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if label is not None:
                    seq = _join_seq(chunks, delete)
                    if len(seq) > 0:
                        yield label, seq, None
                    else:
                        _warn_empty(label)
                label = _proc_label(line[1:])
                chunks = []
            elif line:
                chunks.append(line)
        if label is not None:
            seq = _join_seq(chunks, delete)
            if len(seq) > 0:
                yield label, seq, None
            else:
                _warn_empty(label)


def read_fastq(path: str) -> Iterator[Record]:
    with open_maybe_gz(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            hdr = hdr.rstrip(b"\r\n")
            if not hdr:
                continue
            if not hdr.startswith(b"@"):
                raise ValueError(f"bad FASTQ record header: {hdr[:40]!r}")
            seq = f.readline().rstrip(b"\r\n")
            plus = f.readline()
            if not plus.startswith(b"+"):
                raise ValueError("bad FASTQ '+' line")
            qual = f.readline().rstrip(b"\r\n")
            if len(qual) != len(seq):
                raise ValueError("FASTQ seq/qual length mismatch")
            yield (_proc_label(hdr[1:], fastq=True),
                   np.frombuffer(seq, dtype=np.uint8).copy(),
                   qual.decode("latin1"))


def read_fastx(path: str, stream: bool = False) -> Iterator[Record]:
    fmt = sniff_format(path)
    if fmt == "fasta":
        return read_fasta(path, stream=stream)
    if fmt == "fastq":
        return read_fastq(path)
    if fmt == "empty":
        return iter(())
    raise ValueError(f"cannot stream records from {fmt} file: {path}")


def _join_seq(chunks, delete: bytes = b"") -> np.ndarray:
    if not chunks:
        return np.zeros(0, dtype=np.uint8)
    joined = b"".join(chunks)
    if delete:
        joined = joined.translate(None, delete)
    return np.frombuffer(joined, dtype=np.uint8).copy()


def write_fasta(f, label: str, seq: np.ndarray, cols: int = 80) -> None:
    """SeqToFasta (src/fasta.cpp style): wrap at fasta_cols."""
    f.write(f">{label}\n")
    s = seq.tobytes().decode("latin1")
    if cols <= 0:
        f.write(s + "\n")
        return
    for i in range(0, len(s), cols):
        f.write(s[i:i + cols] + "\n")
    if len(s) == 0:
        f.write("\n")


def write_fastq(f, label: str, seq: np.ndarray, qual: str) -> None:
    f.write(f"@{label}\n{seq.tobytes().decode('latin1')}\n+\n{qual}\n")


def file_is_nucleo(path: str) -> bool:
    """FastaFileIsNucleo (src/loaddb.cpp:10-53): first 1024 letters,
    >90% [ACGTUNacgtun] => nucleotide."""
    sample = 1024
    letters = 0
    nuc = 0
    in_label = False
    lastc = b"\n"
    fmt = sniff_format(path)
    is_fastq = fmt == "fastq"
    with open_maybe_gz(path) as f:
        if is_fastq:
            # sample sequence lines only
            for label, seq, _q in read_fastq(path):
                for c in seq[: sample - letters]:
                    letters += 1
                    if chr(c) in "ACGTUNacgtun":
                        nuc += 1
                if letters >= sample:
                    break
            return letters > 0 and nuc / letters > 0.9
        data = f.read(1 << 20)
    for ci in data:
        c = bytes([ci])
        if c == b"\r":
            continue
        if c == b">" and lastc == b"\n":
            in_label = True
        elif in_label and c == b"\n":
            in_label = False
        elif not in_label and c.isalpha():
            letters += 1
            if c in b"ACGTUNacgtun":
                nuc += 1
            if letters >= sample:
                break
        lastc = c
    return letters > 0 and nuc / letters > 0.9
