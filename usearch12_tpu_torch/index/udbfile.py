""".udb binary file format reader/writer (interop with the reference).

Layout (src/udbfile.h:17-61, src/udbio.cpp:227-364, src/seqdbio.cpp):
  UDBFileHdr (packed, 200 bytes):
    u32 Magic1 ('UDBF'=0x55444246), u32 Hashed, u32 SeqIndexBits,
    u32 SeqPosBits, u32 WordWidth, u32 DBStep, u32 DBAccelPct, u32 RFU1,
    u32 RFU2, u32 UTaxData, u32 EndOfRow, u64 SlotCount(hashed only),
    u64 SeqCount, byte StepPrefix[8], char AlphaStr[64], char PatternStr[64],
    u32 Magic2 ('UDBf')
  u32 Sizes[slot_count]
  u32 Magic3 ('UDB3')
  rows: for each slot with Size>0, u32 postings[Size]
  u32 Magic4 ('UDB4')
  SeqDB section:
    SeqDBFileHdr (32 bytes w/ tail padding): u32 Magic1(0x5E0DB3),
    u32 SeqCount, u64 SeqBytes, u32 LabelBytes, u32 SplitCount,
    u32 Magic2(0x5E0DB4) [+4 pad]
    u32 LabelOffsets[SeqCount]; char LabelBuffer[LabelBytes];
    u32 SeqLengths[SeqCount]; bytes seqs (concatenated)
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..io.seqdb import SeqDB
from .udb import UDBIndex, UDBParams

MAGIC1 = 0x55444246  # 'UDBF'
MAGIC2 = 0x55444266  # 'UDBf'
MAGIC3 = 0x55444233  # 'UDB3'
MAGIC4 = 0x55444234  # 'UDB4'
SEQDB_MAGIC1 = 0x5E0DB3
SEQDB_MAGIC2 = 0x5E0DB4

_HDR_FMT = "<11I2Q8s64s64sI"
_HDR_SIZE = struct.calcsize(_HDR_FMT)  # 200


def _cstr(b: bytes) -> str:
    return b.split(b"\0", 1)[0].decode("latin1")


def _decode_var_rows(raw: np.ndarray, byte_sizes: np.ndarray):
    """Decode var-coded rows (concatenated per-slot byte runs of
    (SeqIndex, SeqPos) varint pairs, src/udbdata.h:100-125) into plain
    per-posting target indexes + per-slot POSTING counts."""
    term = (raw & 0x80) != 0          # terminator byte of each varint
    n_varints = int(term.sum())
    assert n_varints % 2 == 0, "odd varint count in var-coded rows"
    # decode every varint: values span [prev_term+1 .. term] bytes
    ends = np.nonzero(term)[0]
    starts = np.concatenate(([0], ends[:-1] + 1))
    vals = np.zeros(len(ends), dtype=np.uint64)
    # varints are at most 5 bytes; accumulate 7-bit groups little-endian
    lens = ends - starts + 1
    for k in range(5):
        mask = lens > k
        b = raw[starts[mask] + k].astype(np.uint64) & 0x7F
        vals[mask] |= b << np.uint64(7 * k)
    tix = vals[0::2].astype(np.int64)   # SeqIndex of each pair
    # per-slot posting counts: pairs per row = varints-in-row / 2
    row_end_bytes = np.cumsum(byte_sizes.astype(np.int64))
    varint_ends_count = np.searchsorted(ends, row_end_bytes - 1,
                                        side="right")
    pairs_cum = varint_ends_count // 2
    counts = np.diff(np.concatenate(([0], pairs_cum)))
    return tix.astype(np.uint32), counts.astype(np.uint32)


def read_udb(path: str):
    """Returns (UDBIndex, SeqDB)."""
    with open(path, "rb") as f:
        hdr = struct.unpack(_HDR_FMT, f.read(_HDR_SIZE))
        (magic1, hashed, seq_index_bits, seq_pos_bits, word_width, db_step,
         accel_pct, _rfu1, _rfu2, _utax, end_of_row, slot_count_h,
         seq_count_h, step_prefix, alpha_str, pattern_str, magic2) = hdr
        if magic1 != MAGIC1 or magic2 != MAGIC2:
            raise ValueError(f"Invalid .udb file: {path}")
        alpha = _cstr(alpha_str)
        nucleo = alpha == "nt"
        if _cstr(pattern_str):
            # the reference itself refuses spaced-seed files at load
            # (ValidateFeatures asserts m_Pattern == 0,
            # src/udbparams.cpp:112-119)
            raise NotImplementedError("spaced-seed .udb not supported "
                                      "(the reference asserts on them)")
        if hashed:
            params = UDBParams(is_nucleo=nucleo, word_length=word_width,
                               alpha_size=4 if nucleo else 20,
                               slot_count=int(slot_count_h), hashed=True)
        else:
            params = UDBParams.global_usearch(nucleo,
                                              word_length=word_width)
        slot_count = params.slot_count

        sizes = np.fromfile(f, dtype=np.uint32, count=slot_count)
        (m3,) = struct.unpack("<I", f.read(4))
        if m3 != MAGIC3:
            raise ValueError(".udb magic3 mismatch")
        var_coded = seq_pos_bits == 0xFF
        if var_coded:
            # var-coded rows (src/udbdata.h:84-125): Sizes are BYTE
            # lengths; rows are (SeqIndex, SeqPos) varint pairs with the
            # terminator byte carrying the high bit
            total_bytes = int(sizes.sum())
            raw = np.fromfile(f, dtype=np.uint8, count=total_bytes)
            postings, sizes = _decode_var_rows(raw, sizes)
        else:
            total = int(sizes.sum())
            postings = np.fromfile(f, dtype=np.uint32, count=total)
            if seq_pos_bits != 0:
                # pos-coded postings: (SeqIndex << SeqPosBits) | Pos
                # (src/udbparams.h:163-178); ranking counts per posting
                postings = postings >> np.uint32(seq_pos_bits)
        (m4,) = struct.unpack("<I", f.read(4))
        if m4 != MAGIC4:
            raise ValueError(".udb magic4 mismatch")

        # SeqDB section
        raw = f.read(32)
        s_magic1, s_seq_count, s_seq_bytes, s_label_bytes, _split, s_magic2 = \
            struct.unpack("<IIQIII", raw[:28])
        if s_magic1 != SEQDB_MAGIC1 or s_magic2 != SEQDB_MAGIC2:
            raise ValueError(".udb seqdb magic mismatch")
        label_offsets = np.fromfile(f, dtype=np.uint32, count=s_seq_count)
        label_buf = f.read(s_label_bytes)
        seq_lengths = np.fromfile(f, dtype=np.uint32, count=s_seq_count)
        seq_buf = np.fromfile(f, dtype=np.uint8, count=int(s_seq_bytes))

    db = SeqDB()
    # labels: one decode + split over the whole buffer (the per-record
    # `label_buf[off:]` slice-then-split is O(total_bytes) PER label —
    # 41 s on a 220k-seq .udb).  Valid only when the offsets are exactly
    # the consecutive C-string layout the reference writes
    # (src/seqdbio.cpp); any mismatch falls back to the per-label path.
    labels = None
    if s_seq_count > 0 and s_label_bytes > 0 and label_buf[-1:] == b"\0":
        parts = label_buf.decode("latin1").split("\0")
        if len(parts) == s_seq_count + 1 and not parts[-1]:
            lens = np.fromiter((len(p) for p in parts[:-1]), np.int64,
                               s_seq_count)
            offs = np.zeros(s_seq_count, np.int64)
            np.cumsum(lens[:-1] + 1, out=offs[1:])
            if np.array_equal(offs, label_offsets.astype(np.int64)):
                labels = parts[:-1]
    if labels is None:
        labels = [_cstr(label_buf[int(label_offsets[i]):])
                  for i in range(s_seq_count)]
    db.labels = labels
    # seqs: consecutive zero-copy views over the one mmap'able buffer
    seq_off = np.zeros(s_seq_count + 1, dtype=np.int64)
    np.cumsum(seq_lengths.astype(np.int64), out=seq_off[1:])
    db.seqs = [seq_buf[seq_off[i]:seq_off[i + 1]]
               for i in range(s_seq_count)]
    db._bulk_buf = seq_buf
    db._bulk_off = seq_off
    db.set_is_nucleo(nucleo)

    idx = UDBIndex(params)
    idx.db_step = int(db_step) if db_step else 1
    idx.seq_count = s_seq_count
    starts = np.zeros(slot_count + 1, dtype=np.int64)
    np.cumsum(sizes.astype(np.int64), out=starts[1:])
    idx._starts = starts
    idx._sizes = sizes.astype(np.int64)
    idx._postings = postings.astype(np.int32)
    idx._flat_dirty = False
    return idx, db


def write_udb(path: str, idx: UDBIndex, db: SeqDB) -> None:
    from ..config import options
    o = options()
    params = idx.params
    sizes = idx.sizes.astype(np.uint32)
    postings = idx.postings.astype(np.uint32)
    accel = o.uns("dbaccel") if o.filled("dbaccel") else 100
    if accel < 100:
        # -dbaccel (src/udbio.cpp:292-326): keep the smallest postings
        # rows (ascending Hoare-quicksort order) until accel% of the
        # postings are retained; the heaviest rows are dropped.
        from ..search.hitmgr import quick_sort_order
        order = quick_sort_order(sizes.astype(np.int64).tolist(),
                                 desc=False)
        total = int(sizes.sum())
        limit = int(total * accel / 100.0)
        kept = np.zeros_like(sizes)
        acc = 0
        for k in order:
            kept[k] = sizes[k]
            acc += int(sizes[k])
            if acc >= limit:
                break
        starts = idx.starts
        rows = [postings[starts[w]:starts[w] + kept[w]]
                for w in np.nonzero(kept)[0]]
        postings = (np.concatenate(rows).astype(np.uint32)
                    if rows else np.zeros(0, np.uint32))
        sizes = kept
    alpha = b"nt" if params.is_nucleo else b"aa"
    with open(path, "wb") as f:
        hdr = struct.pack(
            _HDR_FMT, MAGIC1, 0, 32, 0, params.word_length, 1, accel, 0, 0,
            0, 0, 0, len(db), b"", alpha, b"", MAGIC2)
        # truncation guard (src/udbio.cpp:285-288): write an INVALID
        # header first and rewrite it after the body completes, so a
        # crashed/partial write is detected as an invalid .udb
        f.write(b"\0" * len(hdr))
        sizes.tofile(f)
        f.write(struct.pack("<I", MAGIC3))
        postings.tofile(f)
        f.write(struct.pack("<I", MAGIC4))
        # SeqDB section
        labels = [lbl.encode("latin1") + b"\0" for lbl in db.labels]
        label_bytes = sum(len(b) for b in labels)
        seq_bytes = db.letter_count()
        f.write(struct.pack("<IIQIII", SEQDB_MAGIC1, len(db), seq_bytes,
                            label_bytes, 0, SEQDB_MAGIC2))
        f.write(b"\0\0\0\0")  # struct tail padding
        offs = np.zeros(len(db), dtype=np.uint32)
        off = 0
        for i, b in enumerate(labels):
            offs[i] = off
            off += len(b)
        offs.tofile(f)
        f.write(b"".join(labels))
        np.array([len(s) for s in db.seqs], dtype=np.uint32).tofile(f)
        for s in db.seqs:
            s.tofile(f)
        # body complete: stamp the valid header
        f.seek(0)
        f.write(hdr)


def makeudb_usearch(input_path: Optional[str]) -> None:
    """cmd_makeudb_usearch (src/makeudb.cpp:27-60)."""
    from ..config import options
    o = options()
    out = o.str("output")
    if not input_path or not out:
        raise SystemExit("Missing input or output filename")
    db = SeqDB.from_fastx(input_path)
    db.mask()
    params = None
    if o.filled("wordlength"):
        # UDBParams::FromCmdLine (src/udbparams.cpp:62-67)
        params = UDBParams.global_usearch(db.get_is_nucleo(),
                                          word_length=o.uns("wordlength"))
    idx = UDBIndex.from_seqdb(db, params)
    write_udb(out, idx, db)


def udb2bitvec(input_path: Optional[str]) -> None:
    """cmd_udb2bitvec (src/udb2bitvec.cpp:5-49): word-present bitvector
    from a .udb, LSB-first bit packing (src/bitvec.cpp:40-49), file =
    uint32 word length + SlotCount/8+1 bytes."""
    from ..config import options
    o = options()
    out = o.str("output")
    if not input_path:
        raise SystemExit("Missing input filename")
    if not out:
        raise SystemExit("Missing -output")
    idx, _db = read_udb(input_path)
    idx._flatten()
    present = idx._sizes > 0
    slot_count = idx.params.slot_count
    nbytes = slot_count // 8 + 1
    packed = np.packbits(present, bitorder="little")
    buf = np.zeros(nbytes, dtype=np.uint8)
    buf[:len(packed)] = packed[:nbytes]
    with open(out, "wb") as f:
        f.write(struct.pack("<I", idx.params.word_length))
        buf.tofile(f)


def read_bitvec(path: str):
    """Loads a bitvec file -> (word_length, present bool array of 4^w)."""
    with open(path, "rb") as f:
        (word_length,) = struct.unpack("<I", f.read(4))
        slot_count = 4 ** word_length
        nbytes = slot_count // 8 + 1
        data = np.fromfile(f, dtype=np.uint8, count=nbytes)
    if len(data) != nbytes:
        raise SystemExit(f"Bad bitvec file size: {path}")
    bits = np.unpackbits(data, bitorder="little")
    return word_length, bits[:slot_count].astype(bool)


def _is_udb(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return struct.unpack("<I", f.read(4))[0] == MAGIC1
    except Exception:
        return False


def load_db(path: str):
    """LoadDB (src/loaddb.cpp:127): dispatch .udb vs FASTA.  Returns
    (SeqDB, UDBIndex-or-None); .udb DBs are already masked/indexed."""
    if _is_udb(path):
        index, db = read_udb(path)
        if len(db) == 0:
            raise SystemExit("Database is empty")
        return db, index
    db = SeqDB.from_fastx(path)
    if len(db) == 0:
        raise SystemExit("Database is empty")
    db.mask()
    return db, None
