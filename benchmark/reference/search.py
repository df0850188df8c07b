"""USEARCH's global search loop (src/search.cpp:89-141, src/terminator.cpp)
over ranked candidates, in plain NumPy: each query's candidates are
aligned in rank order (optimal banded global alignment, dp.py) and a
candidate is accepted where its identity (identical M columns over the
columns from the first to the last M) is at least -id; the loop stops at
-maxaccepts accepts or -maxrejects rejects, or when the list ends."""

from __future__ import annotations

import numpy as np

from . import dp


def accept_loop(queries, lists, targets, pen: dp.Penalties, radius: int,
                min_id: float, maxaccepts: int, maxrejects: int):
    """[[(target, path), ...]] the accepted hits of each query, in order
    of acceptance; lists[q] is the query's ranked candidate targets."""
    n = len(queries)
    hits = [[] for _ in range(n)]
    rejects = np.zeros(n, np.int64)
    pos = np.zeros(n, np.int64)
    min_id = float(np.float32(min_id))
    while True:
        live = [q for q in range(n)
                if len(hits[q]) < maxaccepts and rejects[q] < maxrejects
                and pos[q] < len(lists[q])]
        if not live:
            return hits
        pairs = [(queries[q], targets[int(lists[q][pos[q]])]) for q in live]
        _, paths = dp.align(pairs, [pen] * len(pairs), radius,
                            traceback=True)
        for q, (a, b), path in zip(live, pairs, paths):
            t = int(lists[q][pos[q]])
            pos[q] += 1
            _, alnlen, mism, _ = dp.row_fields(a, b, path)
            ops = np.frombuffer(path, np.uint8)
            ids = int((ops == 77).sum()) - mism
            if ids / alnlen >= min_id:
                hits[q].append((t, path))
            else:
                rejects[q] += 1
