"""The sintax command, kept loaded as the device server holds a database.

Set-up (Session) writes the reference as a FASTA (the manual's -db takes
one), parses the configuration's command line and builds one SintaxRun on
the device: the database, its word index, the classifier and the
incidence on the card, as the sintax command builds them for a device its
caller passes.  A request is one query FASTA through
SintaxRun.classify_file, -tabbedout rows out; the rows of the judged
requests are kept, and so are the boots' winners and top counts of each
classified strand (SintaxTorchClassifier.boots, wrapped).  With --trace 1
each chunk's run_chunk is a "bench.boots" range of the trace, and each
request of the window carries the least bytes its boot step moves
(reference.sintax.boot_bytes, from the reference's posting lists and the
request's reads), which sintax_boot_roofline reads.  Those bytes are
counted after the window, in notes() (the harness's first call after it,
before the metrics are read), from the same reference object that judge()
then uses, so that no reference work falls in the set-up.

judge() holds what the timed path produced against the plain reference
(benchmark/reference/sintax.py).  Each check is a count with the limit 0;
the judged requests are those the harness kept (drawn from the seed):

- rows_wrong: of `row_queries` queries sampled from the judged requests,
  those whose tabbed row differs from the reference's.
- winners_wrong: the same queries' classified strands whose boots'
  winners or top counts differ from the reference's (a strand classified
  by one side only counts).

The control (Session.control) sets every tie-break draw the card gets to 0,
so that each boot's winner is its lowest tied target: every count kept,
USEARCH's random tie-break gone.
"""

from __future__ import annotations

import gc
import io
import os
import time

import numpy as np

from benchmark import gen, trace
from benchmark.reference import sintax as ref_sintax

# the command line's options taken from a configuration's "options"
OPTIONS = ("strand", "sintax_cutoff", "boots", "boot_subset", "randseed")


def make_data(spec: dict, seed: int):
    return gen.make_data(spec["bench_dir"], spec["config"], spec["traffic"],
                         seed)


def _options(cfg: dict, db_path: str):
    o = cfg["options"]
    argv = ["-db", db_path]
    for k in OPTIONS:
        argv += [f"-{k}", str(o[k])]
    return argv + list(cfg.get("program_options", [])) + ["-quiet"]


# the reference built for a run's data: (data, its Sintax), built once
_built = [None, None]


def reference(cfg: dict, ref: dict, device) -> ref_sintax.Sintax:
    """The plain reference of the database `ref`, built once a run (the
    roofline's bytes and judge() share it)."""
    if _built[0] is not ref:
        o = cfg["options"]
        _built[:] = ref, ref_sintax.Sintax(
            ref["seqs"], ref["labels"], device, boots=o["boots"],
            subset=o["boot_subset"], randseed=o["randseed"],
            cutoff=o["sintax_cutoff"], both=o["strand"] == "both")
    return _built[1]


class Session:
    """The resident classifier set up and held for the window."""

    def __init__(self, spec, data, seed, work, device, trace_on, mark):
        from usearch12_tpu_torch.amplicon.sintax import SintaxRun
        from usearch12_tpu_torch.cli import parse_argv

        cfg = spec["config"]
        ref, requests = data
        self.cfg, self.ref, self.device = cfg, ref, device
        self.requests = requests
        self.paths = []
        for r, req in enumerate(requests):
            self.paths.append(os.path.join(work, f"q{r}.fa"))
            gen.write_fasta(self.paths[-1], req["labels"], req["seqs"])
        mark("queries written")
        db_path = os.path.join(work, "db.fa")
        gen.write_fasta(db_path, ref["labels"], ref["seqs"])
        mark("reference written")
        # the records of the traced window, whose boot bytes notes() counts
        self.traced = [] if trace_on else None
        parse_argv(_options(cfg, db_path))
        gc.collect()
        t_db = time.perf_counter()
        self.run = run = SintaxRun(device)
        if run.dev_cls is None:
            raise SystemExit(f"the boots run on the host ({run.reason})")
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
        self.db_ready_s = time.perf_counter() - t_db
        mark("db ready")
        os.remove(db_path)
        self.cur = None
        self.pool = len(requests)
        dev = run.dev_cls
        orig = dev.boots

        def boots(seqs, both):
            per_q, winners, tops = orig(seqs, both)
            if self.cur["keep"]:
                self.cur["boots"] += [
                    [None if ji is None else (winners[ji].copy(),
                                              tops[ji].copy())
                     for ji in ixs] for ixs in per_q]
            return per_q, winners, tops
        dev.boots = boots
        if trace_on:
            # each chunk inside a range of the harness's: the profiler
            # copies the innermost range around kernels onto the card's
            # timeline, and trace.py leaves the copy of a bench.* range
            # out of the card's work
            eng = dev._engine
            chunk = eng.run_chunk

            def run_chunk(*args):
                with trace.span(True, "bench.boots"):
                    return chunk(*args)
            eng.run_chunk = run_chunk

    def request(self, r: int, rec: dict) -> None:
        """Request r through the classifier; rec gets its queries and,
        where rec["keep"], its rows and boots."""
        rec.update(queries=len(self.requests[r]["labels"]))
        if rec["keep"]:
            rec["boots"] = []
        if self.traced is not None:
            self.traced.append(rec)
        self.cur = rec
        out = io.StringIO()
        self.run.classify_file(self.paths[r], out)
        if rec["keep"]:
            rec["rows"] = out.getvalue()

    def counters(self) -> dict:
        return dict(self.run.dev_stats)

    def _count_boot_bytes(self) -> float:
        """Each traced request's least boot bytes (boot_bytes) into its
        record; returns the seconds it took."""
        t0 = time.perf_counter()
        rs = reference(self.cfg, self.ref, self.device)
        per_req = {}
        for rec in self.traced:
            r = rec["req"]
            if r not in per_req:
                per_req[r] = ref_sintax.boot_bytes(
                    rs.sizes, rs.T, [u for s in self.requests[r]["seqs"]
                                     for u in rs.strands(s) if u is not None],
                    rs.B)
            rec["boot_bytes"] = per_req[r]
        return time.perf_counter() - t0

    def notes(self):
        """The note lines; after a traced window, also each request's boot
        bytes (_count_boot_bytes())."""
        counted = [] if self.traced is None else [
            f"the boot bytes counted after the window in "
            f"{self._count_boot_bytes():.4f} s"]
        eng = self.run.dev_cls._engine
        inc = getattr(eng, "w_mat", None)
        size = "held by the server" if inc is None else \
            f"{inc.untyped_storage().nbytes()} bytes"
        st = self.run.dev_stats
        return [f"the load to a classifier ready (db_ready_s) "
                f"{self.db_ready_s:.4f} s; the incidence {size}",
                "the program's counters since set-up: " + ", ".join(
                    f"{k} {st[k]}" for k in sorted(st))] + counted

    def control(self):
        """Every tie-break draw the card gets set to 0."""
        eng = self.run.dev_cls._engine
        orig = eng.run_chunk

        def run_chunk(words, nuw, m, stream, rr, timer=None):
            return orig(words, nuw, m, stream, np.zeros_like(rr), timer)
        eng.run_chunk = run_chunk


def _rows(text: str) -> dict:
    """{query label: its tabbed row}."""
    return {line.split("\t", 1)[0]: line + "\n"
            for line in text.splitlines() if line}


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def judge(spec, data, records, seed, device):
    """[(name, value, limit)] for the window's records."""
    cfg, chk = spec["config"], spec["traffic"]["check"]
    ref, requests = data
    sample = [r for r in records if r["keep"] and "error" not in r]
    if not sample:
        return [("requests_checked", 0, -1)]
    # the sampled queries, (record, index in its request)
    queries = [(rec, i) for rec in sample
               for i in range(len(requests[rec["req"]]["labels"]))]
    rng = gen.rng_for(seed, 8)
    pick = sorted(int(x) for x in rng.choice(
        len(queries), min(chk["row_queries"], len(queries)), replace=False))
    rs = reference(cfg, ref, device)
    rows_wrong = winners_wrong = 0
    for rec in sample:
        req = requests[rec["req"]]
        mine = [i for rec_i, i in (queries[p] for p in pick)
                if rec_i is rec]
        want = rs.request(req["labels"], req["seqs"], mine)
        rows = _rows(rec["rows"])
        for i in mine:
            row, strands = want[i]
            rows_wrong += rows.get(req["labels"][i]) != row
            got = rec["boots"][i] if i < len(rec["boots"]) else \
                [None] * len(strands)
            winners_wrong += sum(not _same(g, w)
                                 for g, w in zip(got, strands))
    return [("rows_wrong", rows_wrong, 0),
            ("winners_wrong", winners_wrong, 0)]
