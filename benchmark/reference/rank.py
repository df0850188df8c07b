"""USEARCH's candidate ranking above -big targets (UDBSearchBig,
src/udbusortedsearcherbig.cpp:31-142; src/countsort.cpp:110-192;
src/wordparams.cpp:168-193), in plain PyTorch, written from that
description and not from the port.

A target's words are its distinct 8-letter words (A C G T = 0..3, base-4
numbers) that hold no letter of the database's default mask (fast_mask);
a query's are its distinct words in order of first occurrence,
of which every step-th is looked up (big_step).  The hit stream is the
looked-up words' posting lists end to end, each list in target order; a
target's count is the number of looked-up words it holds, its first touch
its first position in the stream.  NextValue is the largest count seen in
first-touch order before the first target that reaches the query's
highest count; targets below max(NextValue // 2, 1) are dropped and the
rest ranked by count, ties in first-touch order.

tie="index" breaks ties by target index instead: the control, which
keeps the counts and breaks the guarantee of USEARCH's candidate order.
"""

from __future__ import annotations

import numpy as np
import torch

CODE = np.full(256, 255, np.uint8)
CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def _windows(letters: np.ndarray, w: int):
    """(words, valid) of every window of w letters along the last axis."""
    n = letters.shape[-1] - w + 1
    words = np.zeros(letters.shape[:-1] + (n,), np.int64)
    bad = np.zeros(words.shape, bool)
    for k in range(w):
        c = letters[..., k:k + n]
        words = words * 4 + np.where(c == 255, 0, c)
        bad |= c == 255
    return words, ~bad


def _runs(x: np.ndarray):
    """(start, end) of the run of equal values that holds each element,
    along the last axis."""
    n = x.shape[1]
    idx = np.broadcast_to(np.arange(n), x.shape)
    new = np.ones(x.shape, bool)
    new[:, 1:] = x[:, 1:] != x[:, :-1]
    start = np.maximum.accumulate(np.where(new, idx, 0), axis=1)
    nxt = np.where(new, idx, n)
    end = np.full(x.shape, n)
    end[:, :-1] = np.minimum.accumulate(nxt[:, :0:-1], axis=1)[:, ::-1]
    return start, end


def fast_mask(seqs: np.ndarray) -> np.ndarray:
    """(T, L) bool: the letters that USEARCH's default nucleotide database
    mask lowercases (FastMask, src/fastmask.cpp:90-160): in a run of one
    letter of n >= 5, the letters from the third on, the run's last letter
    kept where the run ends the sequence (it then needs n >= 6); in a run
    of n >= 3 equal letter pairs at even or at odd positions, the pairs
    from the second on, unless the run ends the sequence."""
    T, L = seqs.shape
    start, end = _runs(seqs)
    pos = np.arange(L)
    n1 = np.where(end == L, L - 1 - start, end - start)
    mask = (n1 >= 5) & (pos >= start + 2) & ((end < L) | (pos < L - 1))
    for p in (0, 1):
        m = (L - p) // 2
        pairs = seqs[:, p:p + 2 * m].reshape(T, m, 2).astype(np.int32)
        code = pairs[:, :, 0] * 256 + pairs[:, :, 1]
        ps, pe = _runs(code)
        k = np.arange(m)
        hit = (pe < m) & (pe - ps >= 3) & (k > ps)
        mask[:, p:p + 2 * m] |= np.repeat(hit, 2, axis=1)
    return mask


def target_words(seqs: np.ndarray, w: int, device) -> torch.Tensor:
    """(T, U) int32: each target's distinct words, sorted, padded with
    4**w."""
    pad = 4 ** w
    letters = np.where(fast_mask(seqs), 255, CODE[seqs]).astype(np.uint8)
    words, ok = _windows(letters, w)
    words = np.sort(np.where(ok, words, pad), axis=1)
    dup = np.zeros(words.shape, bool)
    dup[:, 1:] = words[:, 1:] == words[:, :-1]
    words = np.sort(np.where(dup, pad, words), axis=1)
    return torch.from_numpy(words.astype(np.int32)).to(device)


def query_words(seq: np.ndarray, w: int) -> np.ndarray:
    """The distinct valid words of a query, in order of first occurrence."""
    words, ok = _windows(CODE[seq], w)
    words = words[ok]
    _, first = np.unique(words, return_index=True)
    return words[np.sort(first)]


def big_step(nuw: int, fract_id: float, w: int, stepwords: int,
             db_step: int = 1) -> int:
    """The step between looked-up query words of a nucleotide -id search
    (GetWordCountingParams: MinFractId is a float)."""
    f = float(np.float32(fract_id))
    wf = 1.0 - (1.0 - f) * w
    if wf < 0.0:
        thresh = 1
    else:
        wf *= nuw // max(db_step, 1)
        thresh = 1 if wf < 1.0 else int(wf)
    return 1 if stepwords == 0 else max(thresh // stepwords, 1)


def rank(queries, twords: torch.Tensor, fract_id: float, w: int,
         stepwords: int, topk: int, tie: str = "first_touch",
         chunk: int = 32):
    """[(targets, counts)] int64 arrays of each query's first `topk`
    ranked candidates."""
    T, _ = twords.shape
    dev = twords.device
    sel = []
    for q in queries:
        uw = query_words(q, w)
        sel.append(uw[::big_step(len(uw), fract_id, w, stepwords)])
    out = []
    tgrid = torch.arange(T, device=dev, dtype=torch.int64)[:, None]
    for lo in range(0, len(sel), chunk):
        part = sel[lo:lo + chunk]
        smax = max([len(s) for s in part] + [1])
        S = np.full((len(part), smax), -1, np.int32)
        for r, s in enumerate(part):
            S[r, :len(s)] = s
        vals = torch.from_numpy(S).to(dev).reshape(1, -1).expand(T, -1)
        vals = vals.contiguous()
        pos = torch.searchsorted(twords, vals).clamp_(max=twords.shape[1] - 1)
        hit = (twords.gather(1, pos) == vals).view(T, len(part), smax)
        count = hit.sum(2, dtype=torch.int64)                 # (T, q)
        touched = count > 0
        kfirst = torch.argmax(hit.to(torch.uint8), 2)           # first word
        if tie == "first_touch":
            key = kfirst * T + tgrid                            # stream order
        elif tie == "index":
            key = tgrid.expand_as(count)
        else:
            raise ValueError(f"tie {tie!r}")
        big = (smax + 1) * T
        maxv = count.max(0).values
        at_max = torch.where(touched & (count == maxv), key, big).min(0).values
        nextv = torch.where(touched & (key < at_max), count, 0).max(0).values
        minv = torch.clamp(nextv // 2, min=1)
        keep = count >= minv
        order = torch.where(keep, count * big + (big - 1 - key), -1)
        k = min(topk, T)
        top = torch.topk(order, k, 0)
        tv, ti = top.values.cpu().numpy(), top.indices.cpu().numpy()
        cnt = count.gather(0, top.indices).cpu().numpy()
        for r in range(len(part)):
            m = tv[:, r] >= 0
            out.append((ti[m, r].astype(np.int64), cnt[m, r].astype(np.int64)))
    return out
