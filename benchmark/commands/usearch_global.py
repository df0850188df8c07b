"""The usearch_global command, resident as the device server holds it.

Set-up (Session) writes the reference and, for an "index": "udb"
configuration, builds its .udb by the port's makeudb_usearch in a process
of its own and keeps it in the checkout (UDB_CACHE, keyed by the
configuration, the seed and a digest of the port's sources and the
reference's generator), so that a run of a seed the checkout has seen
loads the index it built; then it loads the database, builds one
BatchEngine on the device and, with -device_rank, one CSRDeviceRanker and
the engine's rank override, as commands.cmd_usearch_global wires them for
a device its caller passes.
A request is one query FASTA through BatchEngine.run_file, blast6 out.

judge() holds what the timed path produced against the plain reference
(benchmark/reference/).  Each check is a number with the limit 0; the
judged requests are those the harness kept (drawn from the seed), every
answer of them judged:

- rows_vs_paths_wrong: queries whose blast6 rows differ from the rows the
  reference writes from the alignment paths the engine reported for them
  (the emit stage).
- rank_lists_wrong: queries whose ranked candidates (targets and counts,
  as the ranker handed them to the engine) differ from the reference's
  UDBSearchBig ranking (reference/rank.py), the first max(64, maxaccepts
  + maxrejects), the length the program ranks.
- rows_wrong: of `row_queries` sampled queries, those whose blast6 rows
  differ from the reference's search (reference/search.py over the
  reference's ranking).

The control (Session.control) is the reference's ranking with ties broken
by target index instead of first touch (tie="index"), which keeps every
count and breaks USEARCH's candidate order.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

from benchmark import gen, trace
from benchmark.reference import dp, rank, search

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
UDB_CACHE = os.path.join(ROOT, ".bench_cache", "udb")
# where `python -m usearch12_tpu_torch.cli` runs from
PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    importlib.util.find_spec("usearch12_tpu_torch").origin)))
# .udb files kept a configuration, the most recently used
UDB_KEEP = 8
# the search options passed from a configuration's "search"
SEARCH_OPTIONS = ("id", "strand", "maxaccepts", "maxrejects", "band")


def make_data(spec: dict, seed: int):
    return gen.make_data(spec["bench_dir"], spec["config"], spec["traffic"],
                         seed)


def topk(cfg: dict) -> int:
    """The length of the lists the program ranks."""
    s = cfg["search"]
    return max(64, s["maxaccepts"] + s["maxrejects"])


def _options(cfg: dict):
    s = cfg["search"]
    argv = []
    for k in SEARCH_OPTIONS:
        if k in s:
            argv += [f"-{k}", str(s[k])]
    return argv + list(cfg.get("program_options", [])) + ["-quiet"]


def _digest(spec: dict) -> str:
    """Of the port's sources and the reference's generator and
    parameters: what the .udb of a configuration and seed is made from."""
    import usearch12_tpu_torch
    h = hashlib.sha256()
    pkg = os.path.dirname(usearch12_tpu_torch.__file__)
    for d, dirs, files in sorted(os.walk(pkg)):
        dirs.sort()
        for f in sorted(files):
            if f.endswith((".py", ".c", ".h", ".cu", ".cuh")):
                path = os.path.join(d, f)
                h.update(os.path.relpath(path, pkg).encode())
                with open(path, "rb") as fh:
                    h.update(fh.read())
    rs = spec["config"]["reference"]
    h.update(json.dumps(rs, sort_keys=True).encode())
    with open(os.path.join(spec["bench_dir"], "generators",
                           rs["generator"] + ".py"), "rb") as fh:
        h.update(fh.read())
    return h.hexdigest()[:16]


def _evict(prefix: str) -> None:
    """Keep the UDB_KEEP most recently used .udb files of a configuration."""
    files = sorted((f for f in os.listdir(UDB_CACHE)
                    if f.startswith(prefix) and f.endswith(".udb")),
                   key=lambda f: os.path.getmtime(os.path.join(UDB_CACHE, f)),
                   reverse=True)
    for f in files[UDB_KEEP:]:
        os.remove(os.path.join(UDB_CACHE, f))


def _noop(*_args) -> None:
    pass


class Session:
    """The engine set up and held for the window."""

    def __init__(self, spec, data, seed, work, device, trace_on, mark):
        from usearch12_tpu_torch import commands
        from usearch12_tpu_torch.cli import parse_argv
        from usearch12_tpu_torch.config import options
        from usearch12_tpu_torch.engine import BatchEngine
        from usearch12_tpu_torch.engine.emit import Blast6Emitter

        cfg = spec["config"]
        ref, requests = data
        self.requests, self.trace = requests, trace_on
        self.paths = []
        for r, req in enumerate(requests):
            self.paths.append(os.path.join(work, f"q{r}.fa"))
            gen.write_fasta(self.paths[-1], req["labels"], req["seqs"])
        mark("queries written")
        db_path = os.path.join(work, "db.fa")
        if cfg["index"] == "udb":
            os.makedirs(UDB_CACHE, exist_ok=True)
            prefix = f"{cfg['name']}-"
            db_path = os.path.join(UDB_CACHE, f"{prefix}{seed}-"
                                   f"{_digest(spec)}.udb")
            if os.path.exists(db_path):
                os.utime(db_path)
                mark("index found")
            else:
                fasta = os.path.join(work, "db.fa")
                gen.write_fasta(fasta, ref["labels"], ref["seqs"])
                part = db_path + ".part"
                # the user's makeudb_usearch command, in a process of its
                # own: the resident process only loads the index, as a
                # server does
                subprocess.run([sys.executable, "-m",
                                "usearch12_tpu_torch.cli", "-makeudb_usearch",
                                fasta, "-output", part, "-quiet"],
                               cwd=PORT_ROOT, check=True)
                os.remove(fasta)
                os.replace(part, db_path)
                _evict(prefix)
                mark("index built")
        else:
            gen.write_fasta(db_path, ref["labels"], ref["seqs"])
            mark("reference written")
        parse_argv(_options(cfg))
        gc.collect()
        t_db = time.perf_counter()
        db, index = commands.load_db(db_path)
        eng = BatchEngine("usearch_global", db, index=index, device=device)
        self.override = None
        if options().flag("device_rank"):
            from usearch12_tpu_torch.ops.csr_rank import (
                CSRDeviceRanker, make_engine_override)
            ranker = CSRDeviceRanker(eng.index, device, topk=topk(cfg))
            self.override = make_engine_override(ranker, eng)
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
        self.db_ready_s = time.perf_counter() - t_db
        mark("db ready")
        self.engine, self.cfg, self.ref, self.device = eng, cfg, ref, device
        self.emitter = Blast6Emitter(None, db, False)
        self.cur = None
        self.pool = len(requests)
        orig = eng.search_window

        def search_window(jbuf, j_off, collect_hits, rank_override=None,
                          collect_round=None, sc=None):
            rounds = self.cur.get("rounds")
            if rounds is None or collect_round is None:
                return orig(jbuf, j_off, collect_hits,
                            rank_override=rank_override,
                            collect_round=collect_round, sc=sc)

            def keep(hj, ht, hp, hpo, hs):
                rounds.append((hj.copy(), ht.copy(),
                               hp[:int(hpo[-1])].copy(), hpo.copy()))
                collect_round(hj, ht, hp, hpo, hs)
            return orig(jbuf, j_off, collect_hits,
                        rank_override=rank_override, collect_round=keep,
                        sc=sc)
        eng.search_window = search_window

    def _rank(self, jbuf, j_off):
        """The rank override, timed, its lists kept where judged."""
        rec = self.cur
        t = time.perf_counter()
        with trace.span(self.trace, "bench.rank"):
            cand, cnts, out_n = self.override(jbuf, j_off)
        rec["rank_s"] += time.perf_counter() - t
        if rec["keep"]:
            rec["ranks"] = (cand.copy(), cnts.copy(), out_n.copy())
        return cand, cnts, out_n

    def request(self, r: int, rec: dict) -> None:
        """Request r through the engine; rec gets its queries, the
        ranker's seconds and, where rec["keep"], what the check reads."""
        rec.update(queries=len(self.requests[r]["labels"]), rank_s=0.0,
                   ranks=None)
        if rec["keep"]:
            rec["rounds"] = []
        self.cur = rec
        self.emitter.f = io.StringIO()
        self.engine.run_file(
            self.paths[r], _noop, fast_emit=self.emitter,
            rank_override=None if self.override is None else self._rank)
        if rec["keep"]:
            rec["rows"] = self.emitter.f.getvalue()

    def counters(self) -> dict:
        return dict(self.engine.dev_stats)

    def notes(self):
        return [f"the load to a ranker ready (db_ready_s) "
                f"{self.db_ready_s:.4f} s"]

    def control(self):
        """The ranker replaced by the reference's ranking with ties by
        target index."""
        if self.override is None:
            raise SystemExit("no control: the configuration ranks on the "
                             "host")
        srch = self.cfg["search"]
        seqs = self.ref["seqs"]
        twords = rank.target_words(seqs, srch["wordlength"], self.device)
        k, T = topk(self.cfg), len(seqs)
        eng = self.engine

        def override(jbuf, j_off):
            qs = [jbuf[j_off[j]:j_off[j + 1]] for j in range(len(j_off) - 1)]
            lists = rank.rank(qs, twords, srch["id"], srch["wordlength"],
                              srch["stepwords"], k, tie="index")
            cand = np.full((len(qs), k), T, np.uint32)
            cnts = np.zeros((len(qs), k), np.uint32)
            out_n = np.zeros(len(qs), np.int32)
            for j, (t, c) in enumerate(lists):
                cand[j, :len(t)] = t
                cnts[j, :len(t)] = c
                out_n[j] = len(t)
            eng.dev_stats["rank_device_jobs"] += len(qs)
            return cand, cnts, out_n
        self.override = override


def _rows(text: str) -> dict:
    """{query label: sorted blast6 lines}."""
    out = {}
    for line in text.splitlines():
        if line:
            out.setdefault(line.split("\t", 1)[0], []).append(line)
    return {k: sorted(v) for k, v in out.items()}


def _hits(rec: dict):
    """{job: [(target, path bytes)]} of a request, from the rounds the
    engine reported."""
    out = {}
    for hj, ht, hp, hpo in rec["rounds"]:
        for k in range(len(hj)):
            out.setdefault(int(hj[k]), []).append(
                (int(ht[k]), hp[hpo[k]:hpo[k + 1]].tobytes()))
    return out


def judge(spec, data, records, seed, device):
    """[(name, value, limit)] for the window's records."""
    cfg, chk = spec["config"], spec["traffic"]["check"]
    ref, requests = data
    rng = gen.rng_for(seed, 8)
    sample = [r for r in records if r["keep"] and "error" not in r]
    if not sample:
        return [("requests_checked", 0, -1)]
    tseqs, tlabels = ref["seqs"], ref["labels"]
    srch = cfg["search"]
    s = cfg["scoring"]
    pen = dp.penalties(s["match"], s["mismatch"], s["open"], s["ext"],
                       s["term_open"], s["term_ext"])
    out = []
    queries, qlabels, hit_rows, prog_rows = [], [], [], []
    for rec in sample:
        req = requests[rec["req"]]
        rows = _rows(rec["rows"])
        hits = _hits(rec)
        for j, (lab, seq) in enumerate(zip(req["labels"], req["seqs"])):
            queries.append(seq)
            qlabels.append(lab)
            prog_rows.append(rows.get(lab, []))
            hit_rows.append(sorted(
                dp.blast6_row(lab, tlabels[t], seq, tseqs[t], p)
                for t, p in hits.get(j, [])))
    out.append(("rows_vs_paths_wrong",
                sum(a != b for a, b in zip(prog_rows, hit_rows)), 0))

    twords = rank.target_words(tseqs, srch["wordlength"], device)
    ref_lists = rank.rank(queries, twords, srch["id"], srch["wordlength"],
                          srch["stepwords"], topk(cfg))
    del twords
    if any(r["ranks"] is not None for r in sample):
        bound = srch["maxaccepts"] + srch["maxrejects"]
        wrong = 0
        q = 0
        for rec in sample:
            cand, cnts, out_n = rec["ranks"]
            for j in range(len(requests[rec["req"]]["labels"])):
                t, c = ref_lists[q]
                q += 1
                if j >= len(out_n):       # a query the ranker never saw
                    wrong += 1
                    continue
                n = int(out_n[j])
                # the engine takes at most maxaccepts + maxrejects
                # candidates of a list
                wrong += not (min(len(t), bound) <= n <= len(t)
                              and np.array_equal(cand[j, :n], t[:n])
                              and np.array_equal(cnts[j, :n], c[:n]))
        out.append(("rank_lists_wrong", wrong, 0))

    pick = rng.choice(len(queries), min(chk["row_queries"], len(queries)),
                      replace=False)
    pick = sorted(int(i) for i in pick)
    hits = search.accept_loop(
        [queries[i] for i in pick], [ref_lists[i][0] for i in pick],
        tseqs, pen, cfg["reference_radius"], srch["id"],
        srch["maxaccepts"], srch["maxrejects"])
    wrong = 0
    for i, h in zip(pick, hits):
        want = sorted(dp.blast6_row(qlabels[i], tlabels[t], queries[i],
                                    tseqs[t], p) for t, p in h)
        wrong += want != prog_rows[i]
    out.append(("rows_wrong", wrong, 0))
    return out
