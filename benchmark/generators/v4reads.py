"""V4 reads of a taxonomy-labelled reference (taxa.py): each read the
`length` letters of a target drawn uniformly, from the target's V4 offset,
on the plus strand, with `subs` substitutions (a range, drawn uniformly a
read) at distinct positions."""

from __future__ import annotations

import numpy as np

from benchmark.gen import counts_in, substitute


def queries(spec: dict, ref: dict, n: int, rng):
    """(seqs (n, length) uint8, parents (n,) target indices)."""
    parents = rng.integers(0, len(ref["seqs"]), n)
    length = spec["length"]
    seqs = np.empty((n, length), np.uint8)
    for i, t in enumerate(parents):
        at = int(ref["v4"][t])
        seqs[i] = ref["seqs"][t][at:at + length]
    substitute(rng, seqs, counts_in(rng, spec["subs"], n))
    return seqs, parents
