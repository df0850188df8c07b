"""A reference of amplicon OTUs in three levels, all substitutions at
distinct positions, each to another base, their counts uniform in the
given [lo, hi]:

- `clades` templates of `length` random letters;
- `clusters` centroids: centroid c is template c % `clades` with
  `cluster_subs` substitutions;
- `targets` sequences: the centroids, and members, each a centroid drawn
  uniformly with `member_subs` substitutions (0 makes a duplicate),
  shuffled together.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen import ACGT, counts_in, substitute


def reference(spec: dict, rng) -> dict:
    """{"seqs": (targets, length) uint8, "labels": [str]}."""
    n, nc, length = spec["targets"], spec["clusters"], spec["length"]
    if nc > n:
        raise ValueError("more clusters than targets")
    tpl = ACGT[rng.integers(0, 4, (spec["clades"], length))]
    cent = tpl[np.arange(nc) % spec["clades"]]
    substitute(rng, cent, counts_in(rng, spec["cluster_subs"], nc))
    members = cent[rng.integers(0, nc, n - nc)]
    substitute(rng, members, counts_in(rng, spec["member_subs"], n - nc))
    seqs = np.concatenate([cent, members])[rng.permutation(n)]
    prefix = spec.get("label", "t")
    return {"seqs": seqs, "labels": [f"{prefix}{i}" for i in range(n)]}
