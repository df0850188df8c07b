"""The port's state, built from plain fields of another implementation's
objects.

The port has no weights: its state is the scoring parameters, the
database and its index, and each is built from the same files by the
port's own code.  Where a caller already holds such an object from
another implementation (the JAX package's AlnParams or SeqDB, in the
tests that hold the port against it), these converters read its plain
fields and numpy arrays by name and build the port's own object.  They
never import the other implementation's classes.
"""

from __future__ import annotations

import numpy as np

from .io.seqdb import SeqDB
from .scoring import AlnParams

# the 12 gap penalties of the terminal-gap model, in GapParams order
PENALTIES = ("open_a", "open_b", "ext_a", "ext_b",
             "l_open_a", "l_open_b", "r_open_a", "r_open_b",
             "l_ext_a", "l_ext_b", "r_ext_a", "r_ext_b")


def aln_params(src) -> AlnParams:
    """The port's AlnParams with `src`'s alphabet, local penalties, 12
    gap penalties and substitution matrix."""
    ap = AlnParams(subst_mx=np.array(src.subst_mx),
                   nucleo=bool(src.nucleo),
                   local_open=float(src.local_open),
                   local_ext=float(src.local_ext))
    for name in PENALTIES:
        setattr(ap, name, float(getattr(src, name)))
    return ap


def seq_db(src) -> SeqDB:
    """The port's SeqDB with `src`'s labels and sequences (uint8 arrays,
    copied) and its alphabet."""
    db = SeqDB()
    for label, seq in zip(src.labels, src.seqs):
        db.add(label, np.array(seq, dtype=np.uint8))
    db.set_is_nucleo(bool(src.get_is_nucleo()))
    return db
