"""SINTAX (Edgar 2016, bioRxiv 074161; src/sintaxsearcher.cpp,
src/myutils.cpp's random numbers, src/tax.cpp's NameIsInTaxStr), in plain
NumPy and PyTorch, written from that description and not from the port.

- The database's words: each target's distinct 8-letter words (A C G T =
  0..3, base-4 numbers) that hold no letter of USEARCH's default database
  mask (rank.fast_mask), as posting lists, each in ascending target order.
- A query strand's words: its distinct valid words in order of first
  occurrence (rank.query_words); a strand with fewer than 8 is not
  classified.  The minus strand is the read's reverse complement.
- The boots: a strand's draws are the LCG r <- 1664525 r + 1013904223 (mod
  2^32) from r = -randseed, restarted for every strand classified; boot b
  takes draws b m .. b m + m - 1 (m = 32 words a boot), each the word
  uw[r % nuw]; a target's count in the boot is the number of its picks
  whose word the target holds (a word picked twice counts twice).
- The winner of a boot: among the targets at its highest count, in
  ascending order (every target where that count is 0), the (r % ties)-th,
  r the next draw of the global generator (a lagged multiply-with-carry
  seeded from a small LCG at -randseed once a run: mwc_draws), one draw a
  boot, in the order the strands are classified: query by query, the plus
  strand before the minus.
- The tally: the winners' taxonomy strings counted, in the order of a
  std::map (byte order), then ordered by count, highest first, by a Hoare
  quicksort around the middle element (ties keep that sort's order).  The
  top string's names each get the boots that voted for a string holding
  them (NameIsInTaxStr: the name's first occurrence, followed by ',' or
  the end); the confidences are the running products of count * (1 /
  boots) (USEARCH is built with -ffast-math, which turns a division by a
  constant into that product).
- -strand both: the strand whose highest count over its boots is larger,
  the plus strand where equal; the row is "*" where the minus strand's is
  0 (the plus strand's with -strand plus).
- The tabbed row: the label, the names with their confidences to 4 places,
  the strand, and the names down to the last whose confidence is at least
  -sintax_cutoff (a float option: 0.8 is 0.800000011920929), or "*".

Departures: a boot's counts are computed as the product of its pick counts
and the incidence rows of the strand's words, exact in float32 (counts of
at most 32); only a fixed number of words a boot (not "/n") is taken.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rank

W = 8
M32 = 0xFFFFFFFF
_COMP = np.arange(256, dtype=np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


def postings(seqs, w: int = W):
    """(starts, sizes, post) of the database: each word's posting list,
    post[starts[w]:starts[w] + sizes[w]], ascending target indices."""
    T = len(seqs)
    lengths = np.array([len(s) for s in seqs])
    keys = []
    for L in np.unique(lengths):
        ts = np.nonzero(lengths == L)[0]
        group = np.stack([seqs[t] for t in ts])
        letters = np.where(rank.fast_mask(group), 255,
                           rank.CODE[group]).astype(np.uint8)
        words, ok = rank._windows(letters, w)
        key = np.where(ok, words * T + ts[:, None], -1).ravel()
        keys.append(np.unique(key[key >= 0]))
    key = np.sort(np.concatenate(keys))
    word, tgt = key // T, (key % T).astype(np.int32)
    sizes = np.bincount(word, minlength=4 ** w).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return starts, sizes, tgt


def boot_bytes(sizes: np.ndarray, targets: int, strands, boots: int) -> int:
    """The least bytes a boot step reads and writes for these strands (each
    a word array of a classified strand): every distinct word's posting
    list at 4 bytes a target or a bit a target, whichever is smaller, read
    once, and 8 bytes a boot a strand written (its winner and top count)."""
    if not strands:
        return 0
    words = np.unique(np.concatenate(strands))
    row = np.minimum(4 * sizes[words], -(-targets // 8))
    return int(row.sum()) + 8 * boots * len(strands)


def lcg_stream(seed: int, n: int) -> np.ndarray:
    """The first n draws of a strand's boot LCG."""
    out = np.empty(n, np.int64)
    r = seed & M32
    for k in range(n):
        r = (1664525 * r + 1013904223) & M32
        out[k] = r
    return out


def mwc_draws(seed: int, n: int) -> np.ndarray:
    """The first n draws of USEARCH's global generator from seed: an LCG
    (x <- 214013 x + 2531011) run 10 steps, its next 5 values the lags
    x0..x4, 100 draws discarded; a draw is s = 2111111111 x3 + 1492 x2 +
    1776 x1 + 5115 x0 + x4, the lags moved up one (x3 <- x2 <- x1 <- x0),
    x4 the carry s >> 32 and x0 = s mod 2^32, the draw."""
    st = seed & M32
    for _ in range(10):
        st = (214013 * st + 2531011) & M32
    x = []
    for _ in range(5):
        st = (214013 * st + 2531011) & M32
        x.append(st)
    x0, x1, x2, x3, x4 = x
    out = np.empty(n, np.int64)
    for k in range(-100, n):
        s = 2111111111 * x3 + 1492 * x2 + 1776 * x1 + 5115 * x0 + x4
        x3, x2, x1 = x2, x1, x0
        x4, x0 = s >> 32, s & M32
        if k >= 0:
            out[k] = x0
    return out


def _quicksort_desc(vals):
    """Positions of vals by value, highest first: Hoare's partition around
    the middle element, recursing into both sides."""
    order = list(range(len(vals)))

    def sort(lo, hi):
        i, j = lo, hi
        pivot = vals[order[(lo + hi) // 2]]
        while i <= j:
            while vals[order[i]] > pivot:
                i += 1
            while vals[order[j]] < pivot:
                j -= 1
            if i <= j:
                order[i], order[j] = order[j], order[i]
                i, j = i + 1, j - 1
        if lo < j:
            sort(lo, j)
        if i < hi:
            sort(i, hi)
    if order:
        sort(0, len(order) - 1)
    return order


def _name_in(tax: str, name: str) -> bool:
    n = tax.find(name)
    return n >= 0 and (n + len(name) == len(tax) or tax[n + len(name)] == ",")


class Sintax:
    """The classifier of a database (seqs, labels) with its options; the
    boots' counts on `device`."""

    def __init__(self, seqs, labels, device, boots: int = 100,
                 subset: int = 32, randseed: int = 1, cutoff: float = 0.8,
                 both: bool = True, chunk: int = 16) -> None:
        self.T = len(seqs)
        self.starts, self.sizes, self.post = postings(seqs)
        self.tax = [next((f[4:] for f in lab.split(";")
                          if f.startswith("tax=")), "") for lab in labels]
        self.device = torch.device(device)
        self.B, self.m, self.seed = boots, subset, randseed
        self.cutoff = float(np.float32(cutoff))
        self.both, self.chunk = both, chunk
        self.stream = lcg_stream(randseed, boots * subset)

    def strands(self, seq: np.ndarray):
        """The words of each strand classified, None where under 8."""
        out = []
        for s in (seq, revcomp(seq)) if self.both else (seq,):
            uw = rank.query_words(s, W)
            out.append(uw if len(uw) >= 8 else None)
        return out

    def boots(self, strands, draws: np.ndarray):
        """(winners, tops) (n, B) int64 of n strands' words, draws (n, B)
        their global draws."""
        n, B, m = len(strands), self.B, self.m
        win = np.zeros((n, B), np.int64)
        top = np.zeros((n, B), np.int64)
        dev = self.device
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for lo in range(0, n, self.chunk):
                part = strands[lo:lo + self.chunk]
                c, umax = len(part), max(len(u) for u in part)
                jj, kk, tt = [], [], []
                for j, uw in enumerate(part):
                    sz = self.sizes[uw]
                    jj.append(np.full(int(sz.sum()), j))
                    kk.append(np.repeat(np.arange(len(uw)), sz))
                    tt.append(np.concatenate(
                        [self.post[self.starts[w]:self.starts[w] + s]
                         for w, s in zip(uw, sz)]))
                inc = torch.zeros((c, umax, self.T), device=dev)
                inc[tuple(torch.from_numpy(np.concatenate(x)).to(dev)
                          for x in (jj, kk, tt))] = 1.0
                nuw = np.array([len(u) for u in part])
                picks = self.stream.reshape(B, m)[None] % nuw[:, None, None]
                P = torch.zeros((c, B, umax), device=dev)
                P.scatter_add_(2, torch.from_numpy(picks).to(dev),
                               torch.ones((c, B, m), device=dev))
                U = torch.bmm(P, inc)
                t = U.amax(2)
                ties = U == t[..., None]
                r = torch.from_numpy(draws[lo:lo + c]).to(dev) % ties.sum(2)
                hit = ties & (ties.cumsum(2) == (r + 1)[..., None])
                win[lo:lo + c] = hit.to(torch.uint8).argmax(2).cpu().numpy()
                top[lo:lo + c] = t.to(torch.int64).cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return win, top

    def request(self, labels, seqs, pick):
        """{i: (row, [(winners, tops) or None a strand])} of the queries
        `pick` of one query file classified from its start (the global
        generator at -randseed)."""
        jobs = [self.strands(s) for s in seqs]
        n_before = np.cumsum([0] + [sum(u is not None for u in j)
                                    for j in jobs])
        draws = mwc_draws(self.seed, int(n_before[-1]) * self.B).reshape(
            -1, self.B)
        todo, where = [], []
        for i in pick:
            k = n_before[i]
            for si, uw in enumerate(jobs[i]):
                if uw is not None:
                    todo.append(uw)
                    where.append((i, si, k))
                    k += 1
        got = {}
        if todo:
            win, top = self.boots(todo, draws[[k for _, _, k in where]])
            for x, (i, si, _) in enumerate(where):
                got[(i, si)] = (win[x], top[x])
        out = {}
        for i in pick:
            res = [got.get((i, si)) for si in range(len(jobs[i]))]
            out[i] = (self.row(labels[i], res), res)
        return out

    def _tally(self, res):
        """(ordered [(tax, count)], highest count) of a strand."""
        if res is None:
            return [], 0
        win, top = res
        counts = {}
        for t in win:
            counts[self.tax[t]] = counts.get(self.tax[t], 0) + 1
        keys = sorted(counts)
        order = _quicksort_desc([counts[k] for k in keys])
        return [(keys[i], counts[keys[i]]) for i in order], int(top.max())

    def row(self, label: str, res) -> str:
        tallies = [self._tally(r) for r in res]
        (tal_f, twc_f) = tallies[0]
        (tal_r, twc_r) = tallies[1] if self.both else ([], 0)
        strand, tal = ("+", tal_f) if twc_f >= twc_r else ("-", tal_r)
        if (twc_r if self.both else twc_f) == 0 or not tal:
            return f"{label}\t*\t*\t*\n"
        top_tax, top_n = tal[0]
        names = top_tax.split(",")
        ps, p = [], 1.0
        for name in names:
            n = top_n + sum(c for t, c in tal[1:] if _name_in(t, name))
            p *= n * (1.0 / self.B)
            ps.append(p)
        keep = []
        for name, p in zip(names, ps):
            if p < self.cutoff:
                break
            keep.append(name)
        return "".join([label, "\t", ",".join(f"{n}({p:.4f})" for n, p
                                                in zip(names, ps)),
                        "\t", strand, "\t", ",".join(keep) or "*", "\n"])
