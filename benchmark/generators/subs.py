"""Queries, each a target of the reference drawn uniformly with `subs` =
[lo, hi] substitutions at distinct positions, each to another base, the
count uniform in lo..hi."""

from __future__ import annotations

from benchmark.gen import counts_in, substitute


def queries(spec: dict, ref: dict, n: int, rng):
    """((n, L) uint8 queries, (n,) their parent targets)."""
    parents = rng.integers(0, len(ref["seqs"]), n)
    seqs = ref["seqs"][parents].copy()
    substitute(rng, seqs, counts_in(rng, spec["subs"], n))
    return seqs, parents
