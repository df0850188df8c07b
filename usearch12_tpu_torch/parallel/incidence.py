"""The dense int8 word incidence of the mesh paths and its product with
the queries' one-hot word rows.

The incidence is target-major: row t holds target t's word counts over the
V word slots (V padded to a multiple of 8), so a new centroid is one
contiguous row and a "db" shard is a block of rows.  U = Q @ W^T is
torch._int_mm(Q, W.t()): int8 inputs, int32 counts, cuBLASLt on the card.
That call needs more than 16 rows of Q and both other sizes a multiple of
8; the transposed view of the target-major rows is the layout cuBLASLt's
int8 kernels take without a copy ("TN").
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

# rows of Q at least (torch._int_mm takes more than 16)
MIN_ROWS = 24


def pad8(n: int) -> int:
    return n + (-n) % 8


def query_rows(n: int) -> int:
    """Rows of a Q holding n queries: a multiple of 8, at least MIN_ROWS."""
    return max(MIN_ROWS, pad8(n))


def onehot(words: Sequence[np.ndarray], n_rows: int, v_pad: int,
           device: torch.device) -> torch.Tensor:
    """(n_rows, v_pad) int8 with row k set at each of words[k] (rows past
    len(words) stay 0), built on `device` from the word lists."""
    q = torch.zeros((n_rows, v_pad), dtype=torch.int8, device=device)
    lens = [len(w) for w in words]
    if sum(lens):
        lin = (np.repeat(np.arange(len(words), dtype=np.int64) * v_pad, lens)
               + np.concatenate(words).astype(np.int64))
        q.view(-1)[torch.from_numpy(lin).to(device)] = 1
    return q


def target_rows(index, bounds: List[tuple], v_pad: int,
                device: torch.device) -> List[torch.Tensor]:
    """For each (lo, hi, n_rows) of `bounds`, the (n_rows, v_pad) int8
    incidence of targets lo..hi-1 (row r: target lo + r; rows past hi - lo
    stay 0): each (word, target) posting of the index counts 1, as
    np.add.at does in the JAX package.  Built on `device` from the index's
    CSR (sizes, postings)."""
    sizes = torch.from_numpy(np.asarray(index.sizes, np.int64)).to(device)
    post = torch.from_numpy(np.asarray(index.postings, np.int32)).to(device)
    words = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), sizes)
    one = torch.ones(1, dtype=torch.int8, device=device)
    out = []
    for lo, hi, n_rows in bounds:
        w = torch.zeros((n_rows, v_pad), dtype=torch.int8, device=device)
        sel = (post >= lo) & (post < hi)
        lin = (post[sel].to(torch.int64) - lo) * v_pad + words[sel]
        w.view(-1).index_put_((lin,), one, accumulate=True)
        out.append(w)
    return out


def shards(index, mesh, rows: int, v_pad: int) -> dict:
    """The incidence cut into the mesh's "db" shards of `rows` target rows
    each: {(device, j): shard j on that device} for every device of column
    j of the mesh (one copy a device however many rows it serves)."""
    by_dev = {}
    for j in range(mesh.shape["db"]):
        for dev in dict.fromkeys(mesh.devices[:, j]):
            by_dev.setdefault(dev, []).append(j)
    out = {}
    for dev, js in by_dev.items():
        ws = target_rows(index, [(j * rows, (j + 1) * rows, rows) for j in js],
                         v_pad, dev)
        out.update(((dev, j), w) for j, w in zip(js, ws))
    return out


def int8_mm(q: torch.Tensor, w_rows: torch.Tensor) -> torch.Tensor:
    """(R, N) int32 counts q @ w_rows^T of int8 q (R, V) and target rows
    (N, V).  `int8_mm.launches` counts its calls on the card."""
    if q.is_cuda:
        int8_mm.launches += 1
    return torch._int_mm(q, w_rows.t())


int8_mm.launches = 0
