"""A taxonomy-labelled reference of near-full-length 16S genes, in SINTAX's
label format (">name;tax=d:..,p:..,c:..,o:..,f:..,g:..;").

The taxonomy is a tree of the configuration's `ranks` (nodes a rank, each
hung under a parent drawn uniformly, every parent with one child at least);
the genera's sizes are skewed (log-normal weights, `genus_sigma`), each
genus holds 1 + (size - 1) // `per_species` species, and each target is a
copy of its species' template with `strain_subs` substitutions.  Every node
is its parent's template with a binomial number of substitutions (each
letter to another drawn uniformly), the fraction of `template` letters
that puts two targets whose lowest shared rank is r at `identity[r]`:
a letter kept along an edge of fraction f is kept with odds 1 - 4f/3 more
than chance, so two targets agree at a site with probability 1/4 + 3/4
q_r^2, q_r the product of (1 - 4f/3) over the edges from a target up to its
rank-r template; the domains' templates are independent random sequences,
and a phylum's edge is `phylum_edge`.
Each target is a window of `length` letters (uniform in the range) of its
template that holds the V4 amplicon, `v4_at` .. `v4_at + v4_length`; the
reference's "v4" is its offset in each target.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen import ACGT, substitute

RANKS = ("d", "p", "c", "o", "f", "g")


def _parents(rng, n_children: int, n_parents: int) -> np.ndarray:
    """A parent for each child: every parent one child, the rest drawn
    uniformly."""
    out = rng.integers(0, n_parents, n_children)
    out[:n_parents] = np.arange(n_parents)
    return rng.permutation(out)


def _edge(identity: dict) -> dict:
    """The substitution fraction of the edge above a node of each rank
    below the phylum, and of a species' edge ("s"), from the pairwise
    identities of targets whose lowest shared rank is that rank."""
    q = {r: np.sqrt((4.0 * identity[r] - 1.0) / 3.0) for r in RANKS[1:]}
    keep = {"c": q["p"] / q["c"], "o": q["c"] / q["o"], "f": q["o"] / q["f"],
            "g": q["f"] / q["g"], "s": q["g"]}
    return {r: 0.75 * (1.0 - k) for r, k in keep.items()}


def _children(rng, parent_seqs: np.ndarray, parent_of: np.ndarray,
              frac: float) -> np.ndarray:
    seqs = parent_seqs[parent_of]
    substitute(rng, seqs, rng.binomial(seqs.shape[1], frac, len(seqs)))
    return seqs


def reference(spec: dict, rng) -> dict:
    """{"seqs": [uint8 rows of A, C, G and T], "labels", "v4": each
    target's V4 offset}."""
    L, n = spec["template"], spec["targets"]
    counts = spec["ranks"]
    edge = _edge(spec["identity"])
    seqs = ACGT[rng.integers(0, 4, (counts["d"], L))]
    up = {"d": np.zeros(counts["d"], np.int64)}
    for r, prev in zip(RANKS[1:], RANKS):
        up[r] = _parents(rng, counts[r], counts[prev])
        seqs = _children(rng, seqs, up[r],
                         spec["phylum_edge"] if r == "p" else edge[r])
    # lineage: each genus's node at every rank
    lineage = {"g": np.arange(counts["g"])}
    for r, low in zip(RANKS[-2::-1], RANKS[:0:-1]):
        lineage[r] = up[low][lineage[low]]
    # genera's sizes (each at least one), their species and targets
    g_n = counts["g"]
    w = rng.lognormal(0.0, spec["genus_sigma"], g_n)
    size = 1 + rng.multinomial(n - g_n, w / w.sum())
    n_sp = 1 + (size - 1) // spec["per_species"]
    sp_genus = np.repeat(np.arange(g_n), n_sp)
    species = _children(rng, seqs, sp_genus, edge["s"])
    # a genus's targets over its species, each species one at least
    first = np.concatenate([[0], np.cumsum(n_sp)[:-1]])
    t_genus = np.repeat(np.arange(g_n), size)
    k = np.arange(n) - np.repeat(np.cumsum(size) - size, size)
    t_species = first[t_genus] + np.where(
        k < n_sp[t_genus], k, rng.integers(0, n_sp[t_genus]))
    full = species[t_species]
    lo, hi = spec["strain_subs"]
    substitute(rng, full, rng.integers(lo, hi + 1, n))
    order = rng.permutation(n)
    full, t_genus = full[order], t_genus[order]
    # a window of each template that holds the V4 amplicon
    a, b = spec["length"]
    length = rng.integers(a, b + 1, n)
    v4, v4_end = spec["v4_at"], spec["v4_at"] + spec["v4_length"]
    start = rng.integers(np.maximum(0, v4_end - length),
                         np.minimum(v4, L - length) + 1)
    names = [[f"{r}:{r.upper()}{i}" for i in range(counts[r])]
             for r in RANKS]
    tax = [",".join(names[j][lineage[r][g]] for j, r in enumerate(RANKS))
           for g in range(g_n)]
    prefix = spec.get("label", "t")
    return {"seqs": [full[i, start[i]:start[i] + length[i]]
                     for i in range(n)],
            "labels": [f"{prefix}{i};tax={tax[t_genus[i]]};"
                       for i in range(n)],
            "v4": (v4 - start).astype(np.int64)}
