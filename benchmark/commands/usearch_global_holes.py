"""usearch_global on long reads whose chains leave holes for the hole DP:
the usearch_global module's set-up and request (its Session: the .udb
built once and kept in the checkout, one resident BatchEngine, a request
one query FASTA through run_file, blast6 out), with every call of the
engine's BatchEngine._align_holes watched.

For the judged requests the module keeps every hole the chain handed to
_align_holes: its letters, its class (which ends take terminal gap
penalties), its route (the card, where the gate dispatched the call and
the band fits the kernels, else the host C kernel) and the path the
engine returned.  In a traced run it keeps each dispatched hole's lengths
for holedp_roofline, and marks each call that has holes with a
"bench.holes" range, so that the breakdown's idle time splits the holes
from the rest of a request.

The module also keeps, for the judged requests, the host ranker's lists
(BatchEngine._rank_jobs) and each round's replay input
(BatchEngine._finish_round: the pairs chained, their status, the chain's
splice plan and the holes' paths) and what the replay consumed, so that
every chained pair's whole path can be spliced here from the plan.  A
request is one window of the engine (64 reads; the window is 8,192).

judge() holds what the timed path produced against the plain reference.
Each check is a count with the limit 0:

- rank_lists_wrong: judged reads whose ranked candidates (targets and
  counts, as the host ranker handed them to the engine) differ from
  reference/usorted.py's ranking at or below -big targets, the first
  maxaccepts + maxrejects, the length the engine ranks;
- pairs_wrong: judged reads whose candidates the engine did not chain in
  the reference's order, or whose count of pairs the replay consumed
  differs from the reference's walk: the reference's candidates in order,
  each accepted where the reference finds the identity of its chained
  path (identical M columns over the columns from the first M to the
  last) at or above -id, a pair without a path (no HSP) rejected, until
  maxaccepts accepts or maxrejects rejects;
- accepts_wrong: judged reads whose accepted targets (the rows' pairs)
  differ from that walk's, or with a chained path that does not consume
  both sequences;
- holes_wrong: holes whose returned path differs from the reference's
  (reference/holes.py: dp.align at the engine's band radius with the
  hole's class's penalties), or whose path scores otherwise, or that have
  no path;
- holes_unjudged_on_card: 1 when no judged hole went to the card;
- rows_vs_paths_wrong: queries whose blast6 rows differ from those the
  reference writes from the engine's reported paths, as usearch_global's
  judge counts it.

usearch_global's rows_wrong is left out: it holds each row against an
optimal banded alignment of the whole read, which the engine's chained
alignment (HSPs joined through holes, src/globalalignmem.cpp) is not once
reads carry indels.  So the HSPs themselves, and the chain through them,
are the engine's: the checks hold every hole of them, the candidates, the
identities and the accept and stop rules.  The control (Session.control)
puts the reference DP from the other end (reversed sequences, mirrored
class: the same scores, other optimal paths) in the card's aligners'
place.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark import gen, trace
from benchmark.reference import dp, holes, usorted

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
base = gen.plugin(BENCH, "commands", "usearch_global")
make_data = base.make_data
# the chain's splice plan (native/usearch_engine.c): segment kinds, and the
# status of a pair that has a plan
SEG_M, SEG_I, SEG_D, SEG_HOLE, SEG_LIT = range(5)
PAIR_PLAN = 1


class Session(base.Session):
    """usearch_global's Session with the engine's host ranker, hole DP and
    replay watched."""

    def __init__(self, spec, data, seed, work, device, trace_on, mark):
        super().__init__(spec, data, seed, work, device, trace_on, mark)
        eng = self.engine
        orig = eng._align_holes
        db = eng._db_concat

        def align_holes(sc, jbuf, n_hole):
            if n_hole == 0:
                return orig(sc, jbuf, n_hole)
            rec = self.cur
            aoff = sc.hole_aoff[:n_hole].copy()
            boff = sc.hole_boff[:n_hole].copy()
            alen = sc.hole_alen[:n_hole].astype(np.int64)
            blen = sc.hole_blen[:n_hole].astype(np.int64)
            cls = sc.hole_cls[:n_hole].copy()
            before = eng.dev_stats["dispatches"]
            with trace.span(self.trace, "bench.holes"):
                paths, off = orig(sc, jbuf, n_hole)
            card = (eng.dev_stats["dispatches"] > before) & (
                np.abs(alen - blen) + 2 * eng.ah.band_radius + 1
                <= eng.BW_DEV_MAX)
            if "dev_holes" in rec and card.any():
                rec["dev_holes"].append((alen[card], blen[card]))
            if rec["keep"]:
                rec["holes"].append({
                    "a": [jbuf[o:o + n].copy() for o, n in zip(aoff, alen)],
                    "b": [db[o:o + n].copy() for o, n in zip(boff, blen)],
                    "cls": cls, "card": card,
                    "paths": [paths[off[k]:off[k + 1]].tobytes()
                              for k in range(n_hole)]})
            return paths, off
        eng._align_holes = align_holes
        rank_jobs, finish_round = eng._rank_jobs, eng._finish_round

        def ranked(jbuf, j_off, sc=None):
            out = rank_jobs(jbuf, j_off, sc)
            if self.cur["keep"]:
                self.cur["ranked"].append(tuple(x.copy() for x in out))
            return out

        def replayed(sc, jbuf, j_off, pair_j, pair_t, status, pair_seg_off,
                     hole_paths, hole_off, job_state):
            res = finish_round(sc, jbuf, j_off, pair_j, pair_t, status,
                               pair_seg_off, hole_paths, hole_off, job_state)
            if self.cur["keep"]:
                n_seg = int(pair_seg_off[len(pair_j)])
                kind = sc.seg_kind[:n_seg].copy()
                val, val2 = sc.seg_val[:n_seg].copy(), sc.seg_val2[:n_seg]
                lit = val[kind == SEG_LIT] + val2[kind == SEG_LIT]
                self.cur["replays"].append({
                    "j": pair_j.copy(), "t": pair_t.copy(),
                    "status": status.copy(),
                    "seg_off": pair_seg_off[:len(pair_j) + 1].copy(),
                    "kind": kind, "val": val, "val2": val2.copy(),
                    "lit": sc.lit_buf[:int(lit.max()) if len(lit) else 0]
                    .tobytes(),
                    "hole_paths": hole_paths[:int(hole_off[-1])].tobytes(),
                    "hole_off": hole_off.copy(), "used": res[5].copy()})
            return res
        eng._rank_jobs, eng._finish_round = ranked, replayed

    def request(self, r: int, rec: dict) -> None:
        if rec["keep"]:
            rec.update(holes=[], ranked=[], replays=[])
        if self.trace:
            rec["dev_holes"] = []
        super().request(r, rec)

    def notes(self):
        from usearch12_tpu_torch.ops import wavefront_nw, wavefront_trace
        ds = self.engine.dev_stats
        keys = ("dispatches", "device_cells", "host_cells", "holes_n",
                "holedp_pairs", "holedp_launches", "holedp_thread_launches")
        return super().notes() + [
            "the engine since set-up: " + ", ".join(
                f"{k} {ds[k]}" for k in keys if k in ds)
            + f"; kernel launches wavefront_fwd "
            f"{wavefront_nw.wavefront_fwd.launches}, wavefront_trace "
            f"{wavefront_trace.wavefront_trace.launches}"]

    def control(self):
        """The card's aligners replaced by the reference DP from the
        other end."""
        scoring = self.cfg["scoring"]

        class FromTheEnd:
            def __init__(self, cls_bits: int) -> None:
                self.cls = cls_bits

            def align(self, pairs, band_radius, nucleo=True, **_kw):
                sc, ps = holes.align([(a, b, self.cls) for a, b in pairs],
                                     scoring, band_radius,
                                     from_the_end=True)
                return sc, [p.decode("ascii") for p in ps]
        self.engine._class_fused_aligner = FromTheEnd


def _rows_vs_paths(records, data) -> int:
    """Queries whose blast6 rows differ from those written from the
    engine's reported paths (usearch_global's judge's count)."""
    ref, requests = data
    wrong = 0
    for rec in records:
        req = requests[rec["req"]]
        rows, hits = base._rows(rec["rows"]), base._hits(rec)
        for j, (lab, seq) in enumerate(zip(req["labels"], req["seqs"])):
            want = sorted(dp.blast6_row(lab, ref["labels"][t], seq,
                                        ref["seqs"][t], p)
                          for t, p in hits.get(j, []))
            wrong += rows.get(lab, []) != want
    return wrong


def holes_wrong(records, scoring: dict, radius: int) -> int:
    """Judged holes whose path is missing, differs from the reference's or
    scores otherwise."""
    hs, got = [], []
    for rec in records:
        for call in rec["holes"]:
            for k, (a, b) in enumerate(zip(call["a"], call["b"])):
                hs.append((a, b, int(call["cls"][k])))
                got.append(call["paths"][k] if k < len(call["paths"])
                           else None)
    scores, paths = holes.align(hs, scoring, radius)
    wrong = 0
    for (a, b, c), p, s, want in zip(hs, got, scores, paths):
        wrong += p is None or p != want or dp.path_score(
            a, b, p, holes.penalties(scoring, c)) != float(s)
    return wrong


def _splice(rp: dict, p: int) -> bytes:
    """Pair p's whole path, from its splice plan and the holes' paths."""
    parts = []
    off = rp["hole_off"]
    for s in range(int(rp["seg_off"][p]), int(rp["seg_off"][p + 1])):
        k, v = int(rp["kind"][s]), int(rp["val"][s])
        if k == SEG_M:
            parts.append(b"M" * v)
        elif k == SEG_I:
            parts.append(b"I" * v)
        elif k == SEG_D:
            parts.append(b"D" * v)
        elif k == SEG_HOLE:
            parts.append(rp["hole_paths"][off[v]:off[v + 1]])
        else:
            parts.append(rp["lit"][v:v + int(rp["val2"][s])])
    return b"".join(parts)


def _chained(rec):
    """({job: [(target, whole path or None)]} in chain order, {job: pairs
    the replay consumed}) of a judged request."""
    chained, used = {}, {}
    for rp in rec["replays"]:
        for p, (j, t) in enumerate(zip(rp["j"].tolist(), rp["t"].tolist())):
            chained.setdefault(j, []).append(
                (t, _splice(rp, p) if rp["status"][p] == PAIR_PLAN
                 else None))
        for j in np.nonzero(rp["used"])[0].tolist():
            used[j] = used.get(j, 0) + int(rp["used"][j])
    return chained, used


def fract_id(a, b, path: bytes):
    """USEARCH's identity of a global path (GetFractId): identical M
    columns over the columns from the first M to the last; None where the
    path does not consume exactly a and b or has no M."""
    ops = np.frombuffer(path, np.uint8)
    if not (np.isin(ops, np.frombuffer(b"MDI", np.uint8)).all()
            and int((ops != ord("I")).sum()) == len(a)
            and int((ops != ord("D")).sum()) == len(b)
            and (ops == ord("M")).any()):
        return None
    _, alnlen, mism, _ = dp.row_fields(a, b, path)
    return (int((ops == ord("M")).sum()) - mism) / alnlen


def walk(q, targets, chained, tseqs, min_id: float, maxaccepts: int,
         maxrejects: int):
    """(pairs consumed, accepted targets) of the reference's accept loop
    over its ranked `targets`, each judged by the identity of the engine's
    chained path of that pair; pairs consumed is None where the engine did
    not chain the reference's candidate there, or chained a path that does
    not consume both sequences."""
    acc, rej, accepted = 0, 0, []
    for k, t in enumerate(targets.tolist()):
        if k >= len(chained) or chained[k][0] != t:
            return None, accepted
        path = chained[k][1]
        f = None if path is None else fract_id(q, tseqs[t], path)
        if path is not None and f is None:
            return None, accepted
        if f is not None and not f < min_id:
            acc += 1
            accepted.append(t)
        else:
            rej += 1
        if (maxaccepts and acc >= maxaccepts) or \
                (maxrejects and rej >= maxrejects):
            break
    return acc + rej, accepted


def candidates_wrong(records, data, cfg: dict):
    """(rank_lists_wrong, pairs_wrong, accepts_wrong) of the judged
    requests."""
    ref, requests = data
    srch = cfg["search"]
    k = srch["maxaccepts"] + srch["maxrejects"]
    min_id = float(np.float32(srch["id"]))
    inc = usorted.incidence(ref["seqs"], srch["wordlength"])
    ranks = pairs = accepts = 0
    for rec in records:
        req = requests[rec["req"]]
        lists = usorted.rank_lists(req["seqs"], inc, srch["wordlength"], k)
        # one window a request: the engine's job j is the request's read j
        cand, cnts, out_n = rec["ranked"][0] if len(rec["ranked"]) == 1 \
            else (None, None, np.zeros(0, np.int32))
        chained, used = _chained(rec)
        hits = base._hits(rec)
        for j, (q, (t, c)) in enumerate(zip(req["seqs"], lists)):
            n = int(out_n[j]) if j < len(out_n) else -1
            ranks += not (n == len(t) and np.array_equal(cand[j, :n], t)
                          and np.array_equal(cnts[j, :n], c))
            n_walk, accepted = walk(q, t, chained.get(j, []), ref["seqs"],
                                    min_id, srch["maxaccepts"],
                                    srch["maxrejects"])
            pairs += n_walk is None or n_walk != used.get(j, 0)
            accepts += accepted != [x for x, _ in hits.get(j, [])]
    return ranks, pairs, accepts


def judge(spec, data, records, seed, device):
    """[(name, value, limit)] for the window's records."""
    cfg = spec["config"]
    sample = [r for r in records if r["keep"] and "error" not in r]
    if not sample:
        return [("requests_checked", 0, -1)]
    on_card = sum(int(c["card"].sum()) for r in sample for c in r["holes"])
    ranks, pairs, accepts = candidates_wrong(sample, data, cfg)
    return [("rows_vs_paths_wrong", _rows_vs_paths(sample, data), 0),
            ("rank_lists_wrong", ranks, 0),
            ("pairs_wrong", pairs, 0),
            ("accepts_wrong", accepts, 0),
            ("holes_wrong", holes_wrong(sample, cfg["scoring"],
                                        cfg["search"]["band"]), 0),
            ("holes_unjudged_on_card", int(on_card == 0), 0)]
