"""Nanopore reads of rrn operon amplicons (generators/operons.py's held-out
species): each read an operon copy drawn uniformly among the held ones,
on the plus strand, from 16S position `from_16s` to 23S position
`to_23s` (the primers' span), with errors at a rate drawn uniformly in
`error` = [lo, hi] a read: each base is in error with that probability,
the error a substitution (to another base), an insertion (a random base
after it) or a deletion, in equal thirds."""

from __future__ import annotations

import numpy as np

from benchmark.gen import ACGT


def with_errors(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """seq with errors at `rate` a base, a third each substitutions,
    insertions and deletions."""
    n = len(seq)
    kind = np.where(rng.random(n) < rate, rng.integers(0, 3, n), -1)
    out = seq.copy()
    sub = kind == 0
    out[sub] = ACGT[(np.searchsorted(ACGT, seq[sub])
                     + rng.integers(1, 4, int(sub.sum()))) % 4]
    # a deleted base is written 0 times, an inserted one's base and a
    # random one after it
    rep = np.where(kind == 2, 0, np.where(kind == 1, 2, 1))
    out = np.repeat(out, rep)
    ins = np.cumsum(rep)[kind == 1] - 1
    out[ins] = ACGT[rng.integers(0, 4, len(ins))]
    return out


def queries(spec: dict, ref: dict, n: int, rng):
    """([uint8 reads], (n,) their held operons)."""
    parents = rng.integers(0, len(ref["held"]), n)
    rates = rng.uniform(*spec["error"], n)
    seqs = []
    for p, rate in zip(parents, rates):
        op = ref["held"][p]
        amp = op[spec["from_16s"]:int(ref["held_23s"][p]) + spec["to_23s"]]
        seqs.append(with_errors(rng, amp, float(rate)))
    return seqs, parents
