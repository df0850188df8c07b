"""A reference of rrn operons (16S, ITS, 23S) in a tree of genera, species
and operon copies, with species held out of the reference for the reads
(generators/ont.py).

- one template 16S of `s16` random letters and one 23S of `s23`;
- `genera` genera: each the templates with a fraction drawn uniformly in
  `genus_div` of the 16S's letters substituted, and `factor_23s` times
  that fraction of the 23S's;
- `species` + `held_out` species a genus: each its genus's genes with a
  fraction drawn uniformly in `species_div` of the 16S substituted (23S:
  `factor_23s` times), and `its_types` ITS of random letters, their
  lengths uniform in `its` = [lo, hi], shared with no other species;
- `copies` operon copies a species: 16S, the ITS of type copy %
  `its_types`, 23S, with `copy_subs` = [lo, hi] substitutions (uniform
  a copy) over the whole operon.

Every substitution is at a distinct position of its gene and changes the
base.  The first `species` species of every genus are the reference
(genera x species x copies targets, labelled <label><genus>_<species>_
<copy>); the others' copies are "held", each with the offset where its
23S starts ("held_23s").
"""

from __future__ import annotations

import numpy as np

from benchmark.gen import ACGT, substitute


def _diverge(rng, rows: np.ndarray, fracs) -> np.ndarray:
    """A copy of rows with round(fracs[r] x length) letters of row r
    substituted."""
    out = rows.copy()
    substitute(rng, out, np.rint(np.asarray(fracs) * rows.shape[1]).astype(
        np.int64))
    return out


def reference(spec: dict, rng) -> dict:
    """{"seqs": [uint8 operons], "labels", "held": [uint8 operons of the
    held-out species], "held_23s": [offset of each one's 23S],
    "held_genus": [its genus]}."""
    G, S, C = spec["genera"], spec["species"], spec["copies"]
    H, T = spec["held_out"], spec["its_types"]
    f23 = spec["factor_23s"]
    t16 = ACGT[rng.integers(0, 4, (1, spec["s16"]))]
    t23 = ACGT[rng.integers(0, 4, (1, spec["s23"]))]
    gd = rng.uniform(*spec["genus_div"], G)
    g16 = _diverge(rng, np.repeat(t16, G, 0), gd)
    g23 = _diverge(rng, np.repeat(t23, G, 0), f23 * gd)
    prefix = spec.get("label", "t")
    seqs, labels = [], []
    held, held_23s, held_genus = [], [], []
    lo, hi = spec["copy_subs"]
    for g in range(G):
        sd = rng.uniform(*spec["species_div"], S + H)
        s16 = _diverge(rng, np.repeat(g16[g:g + 1], S + H, 0), sd)
        s23 = _diverge(rng, np.repeat(g23[g:g + 1], S + H, 0), f23 * sd)
        for s in range(S + H):
            its = [ACGT[rng.integers(0, 4, rng.integers(
                spec["its"][0], spec["its"][1] + 1))] for _ in range(T)]
            for c in range(C):
                op = np.concatenate([s16[s], its[c % T], s23[s]])[None, :]
                substitute(rng, op, rng.integers(lo, hi + 1, 1))
                if s < S:
                    seqs.append(op[0])
                    labels.append(f"{prefix}{g}_{s}_{c}")
                else:
                    held.append(op[0])
                    held_23s.append(len(s16[s]) + len(its[c % T]))
                    held_genus.append(g)
    return {"seqs": seqs, "labels": labels, "held": held,
            "held_23s": np.array(held_23s, np.int64),
            "held_genus": np.array(held_genus, np.int64)}
