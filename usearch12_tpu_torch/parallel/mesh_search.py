"""usearch_global with its USORT ranking sharded over a mesh (-mesh).

Port of usearch12_tpu/parallel/mesh_search.py.  The mesh's axes are
"data" (query rows) and "db" (target shards):

- the int8 word incidence of the targets (parallel/incidence.py) is cut
  into n_db blocks of target rows, one on each device of the "db" axis;
- each block of query rows (of the "data" axis) gets its counts
  U = Q @ W^T a shard with torch._int_mm, in chunks of rows that bound the
  memory (rows are independent: the bytes do not change);
- SetTopBump (src/udbusortedsearcher.cpp:205-282) as two exclusive prefix
  maxima over the targets in index order, each shard's carried in from
  the shards before it (the JAX all_gather of the shard totals); the
  count sort's NextValue is the prefix maximum at the first global
  maximum, taken from the shard that holds it (the JAX psum);
- each shard's top K by one int64 key a target, count above the global
  target index's complement (count desc, target asc: the order of
  jax.lax.top_k and of the lexicographic merge, with no ties), and one
  top K over the shards' keys on the first device of the row (the JAX
  all_gather and sort).

The JAX collectives are tensor moves inside one process here.  Above -big
targets (with -id) the reference ranks with UDBSearchBig, which these
counts do not give; the ranker then ranks every window with the port's
CSR ranker in its big mode (ops/csr_rank.py) on the mesh's first device,
unsharded.  The JAX MeshRanker ranks with SetTopBump there.

Alignment and output are the batch engine's (engine/batch.py), with the
ranking plugged in as its rank_override, so the bytes equal the host
path's once the candidate lists do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import options
from ..index.udb import UDBIndex
from ..io.seqdb import SeqDB
from ..ops.csr_rank import CSRDeviceRanker, make_engine_override
from ..search.terminator import Terminator
from . import incidence
from .mesh import Mesh

# int32 elements of U in one chunk of rows, over all shards (2^27: 512 MiB)
CHUNK_ELEMS = 1 << 27


class MeshRanker:
    """USORT ranking of query windows over a mesh of torch devices, with
    the JAX MeshRanker's contract (rank_window)."""

    def __init__(self, mesh: Mesh, index: UDBIndex, topk: int = 64,
                 chunk_elems: int = CHUNK_ELEMS) -> None:
        o = options()
        self.mesh = mesh
        self.index = index
        self.topk = topk
        self.bump = int(o.uns("bump"))
        # per-run overhead accounting, as the JAX ranker keeps it:
        # dispatches (one a chunk of rows, each running every shard),
        # the bytes copied to and from the devices, and what the JAX
        # collectives would move, analytic per window of B rows over n_db
        # shards: the prefix-max carries (n_db*B*4 bytes, two with -bump),
        # the top-K gathers (2*B*n_db*K*4) and the NextValue sum (B*4)
        self.overhead = {"dispatches": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                         "all_gather_bytes": 0, "psum_bytes": 0,
                         "windows": 0}
        index._flatten()
        v = index.params.slot_count
        self.v_pad = incidence.pad8(v)
        t = index.seq_count
        self.t = t
        n_db = mesh.shape["db"]
        # a multiple of 8 rows a shard (torch._int_mm)
        self.t_pad = t + ((-t) % (8 * n_db))
        self.t_shard = self.t_pad // n_db
        self.bits = max(int(self.t_pad).bit_length(), 1)
        self.chunk_rows = max(incidence.MIN_ROWS,
                              (chunk_elems // self.t_pad) // 8 * 8)
        self.big = bool(o.filled("id")) and t > o.uns("big")
        self._csr = None
        self._w = {}
        if self.big:
            self._csr = CSRDeviceRanker(index, mesh.devices[0, 0], topk=topk)
        else:
            self._w = incidence.shards(index, mesh, self.t_shard, self.v_pad)

    # -- the stages of one chunk of rows, each shard on its device --------
    def count(self, q: dict, i: int):
        """U of the chunk's one-hot rows q ({device: Q}) a shard."""
        return [incidence.int8_mm(q[self.mesh.devices[i, j]],
                                  self._w[(self.mesh.devices[i, j], j)])
                for j in range(self.mesh.shape["db"])]

    @staticmethod
    def prefix_max(xs):
        """Exclusive prefix maxima along axis 1 of the row-concatenation
        of the shards xs, each shard's carried in from the totals of the
        shards before it."""
        out, carry = [], None
        for x in xs:
            pm = CSRDeviceRanker._excl_prefix_max(x)
            tot = x.max(1).values
            if carry is not None:
                carry = carry.to(x.device)
                pm = torch.maximum(pm, carry[:, None])
                tot = torch.maximum(tot, carry)
            out.append(pm)
            carry = tot
        return out

    def keep(self, us, pms):
        """The SetTopBump keep mask applied to the counts (U where kept,
        else 0): cur_min is the exclusive prefix max of floor(U*bump/100)
        at the records that ratchet it."""
        if self.bump == 0:
            return us
        contrib = []
        for u, pm in zip(us, pms):
            nm = (u * self.bump) // 100
            contrib.append(torch.where((u > pm) & (nm < pm), nm, 0))
        cur = self.prefix_max(contrib)
        return [torch.where(u >= c.clamp_(min=1), u, 0)
                for u, c in zip(us, cur)]

    def top(self, kept, i: int):
        """The merged top K keys of the chunk's rows: each shard's top K,
        then one over the shards' on the row's first device."""
        K = self.topk
        tg = (1 << self.bits) - 1
        keys = []
        for j, u in enumerate(kept):
            gidx = torch.arange(j * self.t_shard, (j + 1) * self.t_shard,
                                device=u.device)
            key = (u.to(torch.int64) << self.bits) | (tg - gidx)
            keys.append(torch.topk(key, min(K, key.shape[1]), 1).values
                        .to(self.mesh.devices[i, 0]))
        allk = torch.cat(keys, 1)
        return torch.topk(allk, min(K, allk.shape[1]), 1).values

    def next_value(self, top_keys, pms):
        """NextValue: the exclusive prefix max of U at the first global
        maximum (the merged list's first target), from the shard that
        holds it."""
        tg = (1 << self.bits) - 1
        p_star = tg - (top_keys[:, 0] & tg)
        nextv = torch.zeros_like(p_star)
        for j, pm in enumerate(pms):
            local = (p_star - j * self.t_shard).to(pm.device)
            mine = (local >= 0) & (local < self.t_shard)
            v = pm.gather(1, local.clamp(0, self.t_shard - 1)[:, None])[:, 0]
            nextv += torch.where(mine, v, 0).to(nextv.device)
        return nextv

    def rank_chunk(self, q: dict, i: int):
        """(top keys (R, k), nextv (R,)) of one chunk of rows."""
        us = self.count(q, i)
        pms = self.prefix_max(us)
        top_keys = self.top(self.keep(us, pms), i)
        return top_keys, self.next_value(top_keys, pms)

    # -- windows ---------------------------------------------------------
    def rank_window(self, jbuf: np.ndarray, j_off: np.ndarray):
        """-> (cand (B, K) int64 global indexes, cnts (B, K) uint32, out_n
        (B,) int32, uncertain (B,) bool): each job's first out_n
        candidates are its ranked list; uncertain jobs need the host's."""
        if self._csr is not None:
            self.overhead["windows"] += 1
            return self._csr.rank_window(jbuf, j_off)
        params = self.index.params
        n_jobs = len(j_off) - 1
        words = [params.unique_words(jbuf[j_off[j]:j_off[j + 1]])
                 for j in range(n_jobs)]
        n_data, n_db = self.mesh.shape["data"], self.mesh.shape["db"]
        K = self.topk
        b_pad = n_jobs + ((-n_jobs) % n_data)
        per = b_pad // n_data
        cnts = np.zeros((n_jobs, K), np.int64)
        cand = np.full((n_jobs, K), self.t, np.int64)
        nextv = np.zeros(n_jobs, np.int64)
        ov = self.overhead
        tg = (1 << self.bits) - 1
        for i in range(n_data):
            for lo in range(i * per, min((i + 1) * per, n_jobs),
                            self.chunk_rows):
                hi = min(lo + self.chunk_rows, (i + 1) * per, n_jobs)
                rows = incidence.query_rows(hi - lo)
                q = {}
                for dev in dict.fromkeys(self.mesh.devices[i]):
                    q[dev] = incidence.onehot(words[lo:hi], rows,
                                              self.v_pad, dev)
                    ov["h2d_bytes"] += 8 * sum(len(w)
                                                for w in words[lo:hi])
                keys, nv = self.rank_chunk(q, i)
                keys = keys[:hi - lo].cpu().numpy()
                k = keys.shape[1]
                cnts[lo:hi, :k] = keys >> self.bits
                cand[lo:hi, :k] = tg - (keys & tg)
                nextv[lo:hi] = nv[:hi - lo].cpu().numpy()
                ov["dispatches"] += 1
                ov["d2h_bytes"] += keys.nbytes + 8 * (hi - lo)
        k = min(K, self.t_shard)
        carries = 2 if self.bump else 1
        ov["all_gather_bytes"] += (carries * n_db * b_pad * 4
                                   + 2 * b_pad * n_db * k * 4)
        ov["psum_bytes"] += b_pad * 4
        ov["windows"] += 1
        cand[cnts == 0] = self.t
        return self._postprocess(cand, cnts, nextv)

    def _postprocess(self, cand, cnts, nextv):
        """Trim the padding targets and empty slots (sorted last) and
        replay the count sort's NextValue/2 cutoff."""
        valid = (cnts > 0) & (cand < self.t)
        first_bad = np.where(valid.all(axis=1), cnts.shape[1],
                             np.argmin(valid, axis=1))
        minv = np.maximum(nextv // 2, 1)
        keep = valid & (cnts >= minv[:, None])
        out_n = np.minimum(first_bad, keep.sum(axis=1)).astype(np.int32)
        # capacity: the true list may run past a full top K, which cannot
        # happen while K >= maxaccepts + maxrejects
        term = Terminator("usearch_global")
        uncertain = (out_n >= self.topk) & \
            (term.max_accepts + term.max_rejects > self.topk)
        return cand, cnts.astype(np.uint32), out_n, uncertain


def mesh_search_file(query_path: str, db: SeqDB, mesh: Mesh,
                     on_query_done, fast_emit=None,
                     index: Optional[UDBIndex] = None,
                     topk: int = 64, window: int = 4096) -> dict:
    """usearch_global with the ranking on the mesh and the alignment in the
    batch engine (the host's C runtime, as in the JAX package).  Returns
    stats {queries, fallbacks (jobs ranked again on the host), overhead,
    dims}."""
    from ..engine.batch import BatchEngine
    eng = BatchEngine("usearch_global", db, index=index)
    ranker = MeshRanker(mesh, eng.index, topk=topk)
    eng.run_file(query_path, on_query_done, window=window,
                 fast_emit=fast_emit,
                 rank_override=make_engine_override(ranker, eng))
    return {"queries": eng.dev_stats["rank_device_jobs"],
            "fallbacks": eng.dev_stats["rank_host_rerank_jobs"],
            "overhead": dict(ranker.overhead),
            "dims": {"v": ranker.index.params.slot_count,
                     "t_pad": ranker.t_pad,
                     "n_db": mesh.shape["db"]},
            "big": ranker.big}
