"""The benchmark's data: a configuration's reference and a traffic mix's
queries, made from the run's seed by generators found by name.

A configuration's "reference" and a mix's "query" each name their
generator ("generator": <name>); generators/<name>.py holds it, with
reference(spec, rng) -> {"seqs", "labels"} or queries(spec, ref, n, rng)
-> (seqs, parents).  A new kind of data is a new file there; a new
configuration or mix of a kind that exists is a new data file.  Sequences
are uint8 ASCII rows of A, C, G and T.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
_LOADED = {}


def plugin(bench_dir: str, kind: str, name: str):
    """The module <bench_dir>/<kind>/<name>.py (a command, a generator, a
    metric's reader), loaded from its file once a process."""
    path = os.path.abspath(os.path.join(bench_dir, kind, name + ".py"))
    if path not in _LOADED:
        if not os.path.exists(path):
            raise SystemExit(f"no {kind} {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def distinct_positions(rng, n: int, length: int, k: int) -> np.ndarray:
    """(n, k) distinct positions in [0, length) a row, in blocks of rows so
    that the random keys stay small."""
    out = np.empty((n, k), np.int64)
    if k == 0:
        return out
    block = max(1, (1 << 22) // length)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        keys = rng.random((hi - lo, length), dtype=np.float32)
        out[lo:hi] = np.argpartition(keys, k - 1, axis=1)[:, :k]
    return out


def substitute(rng, seqs: np.ndarray, counts) -> None:
    """Change counts[r] letters of row r, at distinct positions, each to
    another base (counts: (n,) ints)."""
    counts = np.asarray(counts)
    hi = int(counts.max(initial=0))
    pos = distinct_positions(rng, len(seqs), seqs.shape[1], hi)
    use = np.arange(hi)[None, :] < counts[:, None]
    rows = np.broadcast_to(np.arange(len(seqs))[:, None], pos.shape)
    r, p = rows[use], pos[use]
    old = np.searchsorted(ACGT, seqs[r, p])
    seqs[r, p] = ACGT[(old + rng.integers(1, 4, len(r))) % 4]


def counts_in(rng, lo_hi, n: int) -> np.ndarray:
    """n whole numbers drawn uniformly from lo_hi = [lo, hi]."""
    lo, hi = lo_hi
    return rng.integers(lo, hi + 1, n)


def make_data(bench_dir: str, config: dict, traffic: dict, seed: int):
    """(reference, requests) of a cell and seed: `pool` requests of
    `per_request` queries, each {"labels", "seqs", "parents"}."""
    rs = config["reference"]
    ref = plugin(bench_dir, "generators", rs["generator"]).reference(
        rs, rng_for(seed, 1))
    q = traffic["query"]
    per, pool = traffic["per_request"], traffic["pool"]
    seqs, parents = plugin(bench_dir, "generators", q["generator"]).queries(
        q, ref, per * pool, rng_for(seed, 2))
    prefix = traffic.get("label", "q")
    requests = [{"labels": [f"{prefix}{r}_{i}" for i in range(per)],
                 "seqs": seqs[r * per:(r + 1) * per],
                 "parents": parents[r * per:(r + 1) * per]}
                for r in range(pool)]
    return ref, requests


def write_fasta(path: str, labels, seqs: np.ndarray) -> None:
    """One line of letters a record."""
    with open(path, "wb") as f:
        for lab, s in zip(labels, seqs):
            f.write(b">" + lab.encode() + b"\n" + s.tobytes() + b"\n")
