"""The search step of the port's entry points (entry.py) on torch devices:
shared-word counts, the top-1 candidate and its banded NW score, on one
device and sharded over a mesh; and SINTAX's boot counts as dense
gathers.

Port of usearch12_tpu/parallel/search_step.py.  The layout:

- the word incidence is target-major int8 (parallel/incidence.py): row t
  holds target t's 0/1 word slots, V padded to a multiple of 8.  The
  counts U = Q @ W^T come from torch._int_mm (int8 in, int32 out, exact)
  in chunks of query rows, so that U never holds more than CHUNK_ELEMS
  elements at a time;
- the top-1 candidate is the highest count, the lowest target index on
  ties (torch.argmax returns the first maximum);
- each query is scored against its candidate in the step's band,
  dlo = max(min(la, lb) - 16, 1) and dhi = min(max(la, lb) + 16,
  la + lb - 1), by the port's device-oracle kernels without traceback
  (ops/banded_nw.py: banded_nw_fwd, then banded_nw_chase's final row);
  a pair whose band is wider than their BAND_LANES (126) goes to the
  hole DP's kernels (ops/wavefront_nw.py: wavefront_fwd,
  wavefront_trace), which take bands up to BW_MAX.  Both equal align/oracle.py bit for bit at any
  gap penalties.  Match scores +1, mismatch -2, and a letter of class 4
  or more (N) 0, as in the JAX step.

The sharded step splits the query rows over the mesh's "data" axis and
the target rows over its "db" axis.  Each shard takes its own top-1; the
shards' winners merge on one exact int64 key a row (count, then the
lowest global index); the winning letter rows are gathered from their
shard onto the row block's device.  Rows and targets that do not divide
by the axes are padded with zeros (a padded target never wins: a real
target of a lower index has a count at least as high).

Where the JAX step differs, the port follows align/oracle.py:

- banded_nw_score_jnp runs the TPU kernel's rotating frame of 128 lanes
  with doubling scans, which are exact only for dyadic gap penalties, and
  cuts a band wider than 128 lanes (its score is then -9e9 or NaN);
- its la counts the letters below class 4, so that a query's N shortens
  it; the port pads letter rows with PAD_LETTER instead, and every
  letter of a query counts;
- its sharded step raises unless the rows divide by the "data" axis (and
  the targets by "db"); the port pads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import banded_nw as bn
from ..ops import wavefront_nw as wnw
from ..ops import wavefront_trace as wtr
from . import incidence
from .mesh import Mesh
from .mesh_search import CHUNK_ELEMS

PAD_LETTER = 5          # pads letter rows: no letter of a sequence has it
BAND_SLACK = 16         # the step's band reaches 16 diagonals past both ends
MATCH, MISMATCH = 1.0, -2.0
# bytes of the gathered incidence rows of one chunk of SINTAX queries
BOOT_CHUNK_BYTES = 1 << 30


def build_incidence(index, device: DeviceLike) -> torch.Tensor:
    """(T_pad, V_pad) int8 0/1 word incidence of the index, target-major
    (row t: target t's unique words; T padded to a multiple of 8 with zero
    rows), built on `device` from the CSR postings."""
    t = index.seq_count
    w = incidence.target_rows(index, [(0, t, incidence.pad8(t))],
                              incidence.pad8(index.params.slot_count),
                              resolve_device(device))
    return w[0].clamp_(max=1)


def query_onehot(index, seqs: Sequence[np.ndarray],
                 device: DeviceLike) -> torch.Tensor:
    """(B, V_pad) int8 one-hot rows of each query's unique words."""
    return incidence.onehot([index.params.unique_words(s) for s in seqs],
                            len(seqs),
                            incidence.pad8(index.params.slot_count),
                            resolve_device(device))


def letter_rows(seqs: Sequence[np.ndarray], width: int) -> np.ndarray:
    """(n, width) uint8 nucleotide letter classes of ASCII sequences (A C
    G T/U = 0..3, anything else 4), padded with PAD_LETTER."""
    out = np.full((len(seqs), width), PAD_LETTER, np.uint8)
    for k, s in enumerate(seqs):
        if len(s) > width:
            raise ValueError(f"sequence {k} of {len(s)} letters is longer "
                             f"than the rows' {width}")
        out[k, :len(s)] = wnw.letters(np.asarray(s, np.uint8))
    return out


def step_band(la: torch.Tensor, lb: torch.Tensor):
    """(dlo, bw) int32 of the step's band for each pair."""
    lo, hi = torch.minimum(la, lb), torch.maximum(la, lb)
    dlo = torch.clamp(lo - BAND_SLACK, min=1)
    dhi = torch.minimum(hi + BAND_SLACK, la + lb - 1)
    return dlo.to(torch.int32), (dhi - dlo + 1).to(torch.int32)


def _banded_scores(a, b, la, lb, dlo, bw, gp16):
    _, mlast, dlb = bn.banded_nw_fwd(a, b, la, lb, dlo, bw, gp16, MATCH,
                                     MISMATCH, with_traceback=False)
    return bn.banded_nw_chase(None, mlast, dlb, la, lb, dlo, bw, gp16)[0]


def _wave_scores(a, b, la, lb, dlo, bw, gp16):
    nbytes = wtr.tb_nbytes(la.to(torch.int64), lb.to(torch.int64),
                           bw.to(torch.int64))
    tb_off = torch.cumsum(nbytes, 0) - nbytes
    tb, mlast, dlb = wnw.wavefront_fwd(a, b, la, lb, dlo, bw, tb_off,
                                       int(nbytes.sum()), gp16, MATCH,
                                       MISMATCH)
    return wtr.wavefront_trace(tb, tb_off, mlast, dlb, la, lb, dlo, bw,
                               gp16)[0]


def banded_nw_score(a_let, b_let, la, lb, dlo, bw, gp) -> torch.Tensor:
    """(P,) float32 global NW scores of P pairs in their bands.

    a_let (P, amax), b_let (P, bmax) uint8 letter classes (b not
    pre-shifted); la, lb, dlo, bw (P,) int32 lengths and band
    (dlo <= la - i + j <= dlo + bw - 1); gp the JAX step's 12 float32 gap
    penalties (or the kernels' 16).  Bands of up to BAND_LANES run
    banded_nw_fwd without traceback and banded_nw_chase's final row, wider
    ones wavefront_fwd and wavefront_trace."""
    dev = a_let.device
    gp16 = torch.zeros(16, dtype=torch.float32, device=dev)
    gp16[:gp.numel()] = gp.to(dev, torch.float32)
    scores = torch.empty(a_let.shape[0], dtype=torch.float32, device=dev)
    wide = bw > bn.BAND_LANES
    for sel, route in ((~wide, _banded_scores), (wide, _wave_scores)):
        ix = sel.nonzero()[:, 0]
        if ix.numel():
            scores.index_copy_(0, ix, route(
                *(x.index_select(0, ix) for x in (a_let, b_let, la, lb, dlo,
                                                  bw)), gp16))
    return scores


def _score(a_cls, b_cls, lb, gp) -> torch.Tensor:
    """Scores of each query row against its candidate's letter row."""
    la = (a_cls != PAD_LETTER).sum(1, dtype=torch.int32)
    dlo, bw = step_band(la, lb)
    return banded_nw_score(a_cls, b_cls, la, lb, dlo, bw, gp)


def _chunk_rows(n_targets: int) -> int:
    """Query rows a chunk of U: CHUNK_ELEMS counts, at least MIN_ROWS."""
    return max(incidence.MIN_ROWS, (CHUNK_ELEMS // max(n_targets, 1)) // 8
               * 8)


def _top1(q: torch.Tensor, w_rows: torch.Tensor, chunk_rows: int):
    """(counts (B,) int32, top (B,) int64) of q's rows against the target
    rows w_rows: each row's highest count and its lowest target."""
    B = q.shape[0]
    cnt = torch.empty(B, dtype=torch.int32, device=q.device)
    top = torch.empty(B, dtype=torch.int64, device=q.device)
    for lo in range(0, B, chunk_rows):
        hi = min(lo + chunk_rows, B)
        rows = incidence.query_rows(hi - lo)
        qc = q[lo:hi]
        if rows != hi - lo:
            qc = torch.cat([qc, qc.new_zeros((rows - (hi - lo),
                                              q.shape[1]))])
        u = incidence.int8_mm(qc, w_rows)[:hi - lo]
        t = torch.argmax(u, 1)
        top[lo:hi] = t
        cnt[lo:hi] = u.gather(1, t[:, None])[:, 0]
    return cnt, top


def _check_step_args(amax, q_onehot, db_mat, a_cls, db_cls, db_len):
    if q_onehot.dtype != torch.int8 or db_mat.dtype != torch.int8 \
            or q_onehot.shape[1] != db_mat.shape[1]:
        raise ValueError("q_onehot (B, V) and db_mat (T, V) must be int8 "
                         "with the same V")
    if a_cls.shape[0] != q_onehot.shape[0] or a_cls.shape[1] > amax:
        raise ValueError(f"a_cls: expected {q_onehot.shape[0]} rows of at "
                         f"most {amax} letters, got {tuple(a_cls.shape)}")
    if db_cls.shape[0] != db_len.shape[0] or \
            db_cls.shape[0] > db_mat.shape[0]:
        raise ValueError("db_cls and db_len need one row a target of db_mat")


class SearchStep(nn.Module):
    """The search step on one device.

    forward(q_onehot (B, V) int8, db_mat (T, V) int8 target-major, a_cls
    (B, <= amax) uint8 query letters padded with PAD_LETTER, db_cls
    (T', width) uint8 target letters, db_len (T',) int32 target lengths
    (T' <= T: rows of db_mat past T' are padding), gp (12,) float32) ->
    (counts (B,) int32, top (B,) int32, scores (B,) float32).  The inputs
    are moved to the step's device."""

    def __init__(self, amax: int = 256, device: DeviceLike = None) -> None:
        super().__init__()
        self.amax = amax
        self.device = resolve_device(device)

    def forward(self, q_onehot, db_mat, a_cls, db_cls, db_len, gp):
        q, w, a, b, blen, gp = (x.to(self.device) for x in (
            q_onehot, db_mat, a_cls, db_cls, db_len, gp))
        _check_step_args(self.amax, q, w, a, b, blen)
        cnt, top = _top1(q.contiguous(), w, _chunk_rows(w.shape[0]))
        scores = _score(a.to(torch.uint8), b.to(torch.uint8)[top],
                        blen.to(torch.int32)[top], gp)
        return cnt, top.to(torch.int32), scores


def make_search_step(amax: int = 256, device: DeviceLike = None
                     ) -> SearchStep:
    """The single-device search step: word counts, top-1, banded score."""
    return SearchStep(amax, device)


def _rows(x: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Rows lo .. lo + n - 1 of x, zero rows past its end (a view when x
    holds them all)."""
    if lo + n <= x.shape[0]:
        return x[lo:lo + n]
    out = x.new_zeros((n,) + tuple(x.shape[1:]))
    if lo < x.shape[0]:
        out[:x.shape[0] - lo] = x[lo:]
    return out


class ShardedSearchStep(nn.Module):
    """The search step over a Mesh: query rows on "data", target rows on
    "db".  forward takes SearchStep's arguments (anywhere) and returns its
    outputs on the mesh's first device."""

    def __init__(self, mesh: Mesh, amax: int = 256) -> None:
        super().__init__()
        self.mesh = mesh
        self.amax = amax

    def _shards(self, db_mat, db_cls, db_len, ts: int) -> dict:
        """{(device, j): (incidence rows, letter rows, lengths) of "db"
        shard j}, one copy a device (views where the device holds the
        whole input already)."""
        out = {}
        for j in range(self.mesh.shape["db"]):
            for dev in dict.fromkeys(self.mesh.devices[:, j]):
                out[(dev, j)] = tuple(_rows(x, j * ts, ts).to(dev)
                                      for x in (db_mat, db_cls, db_len))
        return out

    def forward(self, q_onehot, db_mat, a_cls, db_cls, db_len, gp):
        mesh = self.mesh
        n_data, n_db = mesh.shape["data"], mesh.shape["db"]
        _check_step_args(self.amax, q_onehot, db_mat, a_cls, db_cls, db_len)
        B = q_onehot.shape[0]
        per = -(-B // n_data)                    # B padded to n_data blocks
        ts = incidence.pad8(-(-db_mat.shape[0] // n_db))
        bits = max(int(ts * n_db).bit_length(), 1)
        tg = (1 << bits) - 1
        shards = self._shards(db_mat, db_cls.to(torch.uint8),
                              db_len.to(torch.int32), ts)
        chunk_rows = _chunk_rows(ts)
        dev0 = mesh.devices[0, 0]
        cnt = torch.zeros(B, dtype=torch.int32, device=dev0)
        top = torch.zeros(B, dtype=torch.int32, device=dev0)
        scores = torch.zeros(B, dtype=torch.float32, device=dev0)
        for i in range(n_data):
            lo, hi = i * per, min((i + 1) * per, B)
            if lo >= hi:
                continue        # a block of padding rows only
            dev_i = mesh.devices[i, 0]
            keys = []
            for j in range(n_db):
                dev = mesh.devices[i, j]
                c, t = _top1(q_onehot[lo:hi].to(dev).contiguous(),
                             shards[(dev, j)][0], chunk_rows)
                keys.append(((c.to(torch.int64) << bits)
                             | (tg - (t + j * ts))).to(dev_i))
            key = torch.stack(keys).amax(0)
            c_i, t_i = key >> bits, tg - (key & tg)
            # the winners' letter rows and lengths, from their shards
            b_cls = b_len = None
            for j in range(n_db):
                dev = mesh.devices[i, j]
                _, cls_j, len_j = shards[(dev, j)]
                local = (t_i - j * ts).to(dev)
                mine = (local >= 0) & (local < ts)
                ix = local.clamp(0, ts - 1)
                rows = torch.where(mine[:, None], cls_j[ix], 0).to(dev_i)
                lens = torch.where(mine, len_j[ix], 0).to(dev_i)
                b_cls = rows if b_cls is None else b_cls + rows
                b_len = lens if b_len is None else b_len + lens
            sc = _score(a_cls[lo:hi].to(dev_i, torch.uint8), b_cls, b_len,
                        gp.to(dev_i))
            cnt[lo:hi] = c_i.to(dev0, torch.int32)
            top[lo:hi] = t_i.to(dev0, torch.int32)
            scores[lo:hi] = sc.to(dev0)
        return cnt, top, scores


def make_sharded_search_step(mesh: Mesh, amax: int = 256
                             ) -> ShardedSearchStep:
    """The search step sharded over a mesh's "data" and "db" axes."""
    return ShardedSearchStep(mesh, amax)


def _boot_counts_into(out, c0: int, inc, w) -> None:
    """out[:, :, c0:c0 + inc.shape[1]] = boot counts of w against inc's
    columns, a chunk of queries at a time on inc's device."""
    q, boots, m = w.shape
    t = inc.shape[1]
    step = max(1, BOOT_CHUNK_BYTES // max(1, boots * t))
    for lo in range(0, q, step):
        hi = min(lo + step, q)
        acc = torch.zeros((hi - lo, boots, t), dtype=torch.int32,
                          device=inc.device)
        for k in range(m):
            acc += inc.index_select(0, w[lo:hi, :, k].reshape(-1)).view(
                acc.shape)
        out[lo:hi, :, c0:c0 + t] = acc.to(out.device)


def sintax_boot_counts(incidence_vt, words, mesh: Optional[Mesh] = None,
                       device: DeviceLike = None) -> torch.Tensor:
    """SINTAX's boot counts: U[q, boot, t] = the sum over the boot's sampled
    words of incidence_vt[word, t] (src/sintaxsearcher.cpp SetUShuffle as
    dense gathers).

    incidence_vt (V, T) integers (a tensor or an array; the word-major
    layout of amplicon/sintax_device.py); words (Q, BOOTS, M) sampled word
    ids.  Without a mesh the counts run on `device`; with one the targets
    split into ceil(T / n) columns a shard over its "db" axis (its last
    axis when it has none), each counted on its device.  Returns
    (Q, BOOTS, T) int32 on `device`, or on the mesh's first device."""
    inc = torch.as_tensor(incidence_vt)
    if inc.is_floating_point():
        inc = inc.to(torch.int32)
    w = torch.as_tensor(words).to(torch.int64)
    T = inc.shape[1]
    if mesh is None:
        devs = [resolve_device(device)]
    else:
        axis = "db" if "db" in mesh.axis_names else mesh.axis_names[-1]
        devs = list(mesh.devices[0, :] if mesh.axis_names.index(axis) == 1
                    else mesh.devices[:, 0])
    ts = -(-T // len(devs))
    out = torch.empty((w.shape[0], w.shape[1], T), dtype=torch.int32,
                      device=devs[0])
    for j, dev in enumerate(devs):
        c0, c1 = j * ts, min((j + 1) * ts, T)
        if c0 < c1:
            _boot_counts_into(out, c0, inc[:, c0:c1].to(dev), w.to(dev))
    return out
