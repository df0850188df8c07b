"""The sintax command of the port: usearch12_tpu's sintax()
(usearch12_tpu/amplicon/sintax.py) with its device choice replaced.

The boots run on the card (SintaxTorchClassifier) when -sintax_device
asks for it, or, unless -no_sintax_device is given, when the DB has at
least AUTO_MIN_TARGETS targets.  Either way nothing falls back: a build,
launch or memory error on the card raises.  Runs that the device path
cannot take (ineligible(): -self, a hashed index, an incidence over its
limit) run on the host whatever the flags say, as in the JAX package,
and the reason goes into the USEARCH_DEVICE_STATS record.  Everything
else (classifier, windows of 512 queries, tally, output rows) is the JAX
package's.  torch is imported only when the card is chosen.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Optional, Tuple

from usearch12_tpu.alpha import revcomp
from usearch12_tpu.amplicon.sintax import GlobalRand, SintaxClassifier
from usearch12_tpu.amplicon.sintax_device import SintaxDeviceClassifier
from usearch12_tpu.commands import load_db
from usearch12_tpu.config import options
from usearch12_tpu.index.udb import UDBIndex
from usearch12_tpu.io.fastx import read_fastx

if TYPE_CHECKING:
    from ..device import DeviceLike

# Auto gate: the card takes a DB of at least this many targets.  Measured
# on an H100 (700 W) with the port's command line as a fresh process per
# run, 1,500 queries of 248 nt, -strand both: host and card take equal
# time at 63,312 targets (PERF.md).  The card's fixed cost there is
# torch's import and the CUDA start (about 8 s on that machine); the
# classification itself is about 11x faster on the card at 60,000.
AUTO_MIN_TARGETS = 64000
WINDOW = 512


def ineligible(sc: SintaxClassifier) -> Optional[str]:
    """Why the device path cannot take this run, or None: the rules of
    the JAX package's SintaxDeviceClassifier.usable()
    (sintax_device.py:268-278), with the reason each gives.  The
    incidence limit (MAX_INCIDENCE_BYTES, 6 GiB of V x T int8) is the
    TPU's."""
    index = sc.index
    if options().flag("self"):
        return "-self"
    if index.params.hashed:
        return "hashed word index"
    index._flatten()
    if index._postings is None:
        return "no postings"
    nbytes = index.params.slot_count * max(index.seq_count, 1)
    limit = SintaxDeviceClassifier.MAX_INCIDENCE_BYTES
    if nbytes > limit:
        return f"incidence of {nbytes} bytes over {limit}"
    return None


def choose_device(cls: SintaxClassifier) -> Tuple[bool, str]:
    """(run the boots on the card, why)."""
    o = options()
    forced, refused = o.flag("sintax_device"), o.flag("no_sintax_device")
    why = ineligible(cls)
    if why is not None:
        return False, f"ineligible: {why}"
    if forced:
        return True, "-sintax_device"
    if refused:
        return False, "-no_sintax_device"
    n = cls.index.seq_count
    if n >= AUTO_MIN_TARGETS:
        return True, f"auto: {n} >= {AUTO_MIN_TARGETS} targets"
    return False, f"auto: {n} < {AUTO_MIN_TARGETS} targets"


def _row(label, c_strand, pred, ps, last_twc, cutoff) -> str:
    """One -tabbedout line (sintax.py:374-391)."""
    if last_twc == 0:
        return label + "\t*\t*\t*\n"
    out = []
    for i, (n, p) in enumerate(zip(pred, ps)):
        if p < cutoff:
            if i == 0:
                out.append("*")
            break
        out.append(n)
    return "".join([label, "\t",
                    ",".join(f"{n}({p:.4f})" for n, p in zip(pred, ps)),
                    "\t", c_strand, "\t",
                    ",".join(out) if out != ["*"] else "*", "\n"])


def sintax(query_path: Optional[str], device: DeviceLike = None) -> None:
    """-sintax: classify every query against -db; `device` is resolved
    only when the card is chosen."""
    o = options()
    db, index = load_db(o.str("db"))
    if index is None:
        index = UDBIndex.from_seqdb(db)
    if db.get_is_nucleo():
        strand = o.str("strand", "")
        if not strand:
            raise SystemExit("Must specify -strand plus or both with nt db")
        both = strand == "both"
    else:
        both = False   # amino DB: single plus-strand classify
    cls = SintaxClassifier(db, index, GlobalRand(o.uns("randseed")))
    cutoff = o.flt("sintax_cutoff")
    on_card, reason = choose_device(cls)
    dev_cls = None
    if on_card:
        from ..device import resolve_device
        from .sintax_device import SintaxTorchClassifier
        dev_cls = SintaxTorchClassifier(cls, resolve_device(device))

    f = open(o.str("tabbedout"), "w") if o.filled("tabbedout") else None
    try:
        if dev_cls is not None or cls.classify_window([], both) is not None:
            n = _classify_windows(cls, dev_cls, query_path, both, cutoff, f)
            _write_stats(dev_cls is not None, reason, n, index.seq_count)
        else:
            _classify_each(cls, query_path, both, cutoff, f)
    finally:
        if f:
            f.close()


def _classify_windows(cls, dev_cls, query_path, both, cutoff, f) -> int:
    """Windows of WINDOW queries through classify_window; returns the
    number of queries classified."""
    labels, seqs = [], []

    def flush():
        res = (dev_cls or cls).classify_window(seqs, both)
        if f is not None:
            rows = []
            for label, (c_strand, ids, counts, last_twc) in zip(labels, res):
                if last_twc == 0 or not ids:
                    rows.append(_row(label, c_strand, [], [], 0, cutoff))
                else:
                    pred, ps = cls.pred_from_tally(ids, counts)
                    rows.append(_row(label, c_strand, pred, ps, last_twc,
                                     cutoff))
            f.write("".join(rows))
        labels.clear()
        seqs.clear()

    n = 0
    for label, seq, _q in read_fastx(query_path, stream=True):
        if len(seq) == 0:
            continue
        labels.append(label)
        seqs.append(seq)
        n += 1
        if len(seqs) >= WINDOW:
            flush()
    flush()
    return n


def _classify_each(cls, query_path, both, cutoff, f) -> None:
    """One query at a time (sintax.py:496-517), where no window path
    exists (no native library, or a hashed index)."""
    for label, seq, _q in read_fastx(query_path, stream=True):
        if len(seq) == 0:
            continue
        pred_f, ps_f, twc_f = cls.classify(seq)
        if both:
            pred_r, ps_r, twc_r = cls.classify(revcomp(seq))
        else:
            pred_r, ps_r, twc_r = [], [], 0
        if twc_f >= twc_r:
            c_strand, pred, ps = "+", pred_f, ps_f
        else:
            c_strand, pred, ps = "-", pred_r, ps_r
        # the reference's '*' row reads the last classified strand's
        # top word count (sintax.py:508-512)
        last_twc = twc_r if both else twc_f
        if f is not None:
            f.write(_row(label, c_strand, pred, ps, last_twc, cutoff))


def _write_stats(device: bool, reason: str, queries: int,
                 targets: int) -> None:
    """The JAX sintax()'s USEARCH_DEVICE_STATS record, with the reason
    for the device choice."""
    path = os.environ.get("USEARCH_DEVICE_STATS")
    if path:
        with open(path, "a") as sf:
            sf.write(json.dumps({"cmd": "sintax", "device": device,
                                 "reason": reason, "queries": queries,
                                 "targets": targets}) + "\n")
