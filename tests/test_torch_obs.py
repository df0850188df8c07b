"""The port's stage spans and counters (usearch12_tpu_torch/obs.py) on the
CPU: usearch_global with the CSR ranker's override, traced by
torch.profiler, gives usearch.* ranges that nest (each ranker stage
inside the engine's rank stage, every stage inside its request) and
whose number equals the counts in dev_stats; untraced, it enters no
profiler range and makes no CUDA event; the candidate loop's counters
equal what the loop does, also with windows on threads; and the CLI's
host path counts its stages without importing torch."""

import io
import json
import os
import subprocess
import sys
from collections import defaultdict

import pytest
import torch

from tests.genseqs import make_amplicons, write_fasta
from usearch12_tpu_torch import obs
from usearch12_tpu_torch.cli import parse_argv

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_STAGES = ("request", "parse", "rank", "round", "chain", "holes",
                 "replay", "emit", "save")


@pytest.fixture(scope="module")
def amplicons(tmp_path_factory):
    """60 templates as the DB, their 240 reads (substitutions and indels)
    as the queries."""
    d = tmp_path_factory.mktemp("obs")
    recs = make_amplicons(n_templates=60, reads_per_template=4, length=200,
                          seed=31)
    db_fa, q_fa = str(d / "db.fa"), str(d / "q.fa")
    write_fasta(db_fa, [r for r in recs if r[0].startswith("tpl")])
    write_fasta(q_fa, [r for r in recs if not r[0].startswith("tpl")])
    return db_fa, q_fa, sum(not r[0].startswith("tpl") for r in recs)


def _engine(db_fa, q_fa, threads=1, ranker=True):
    """A BatchEngine over db_fa (holes of 64 cells and more batched to
    _align_holes, on the host C kernel) and, with ranker, the CSR
    ranker's override on the CPU."""
    from usearch12_tpu_torch.engine.batch import BatchEngine
    from usearch12_tpu_torch.io.seqdb import SeqDB
    from usearch12_tpu_torch.ops.csr_rank import (CSRDeviceRanker,
                                                  make_engine_override)
    parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                "-strand", "plus", "-threads", str(threads), "-quiet"])
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    eng = BatchEngine("usearch_global", db)
    eng.dev_min_cells = 64
    over = make_engine_override(CSRDeviceRanker(eng.index, CPU), eng) \
        if ranker else None
    return eng, over


def _run(eng, q_fa, over, window=64) -> str:
    from usearch12_tpu_torch.engine.emit import Blast6Emitter
    em = Blast6Emitter(io.StringIO(), eng.db, False)
    eng.run_file(q_fa, None, window=window, fast_emit=em,
                 rank_override=over)
    return em.f.getvalue()


def _inside(r, outer) -> bool:
    return any(s <= r[0] and r[1] <= e for s, e in outer)


def test_profiled_ranges_nest_and_match_the_counts(amplicons):
    db_fa, q_fa, _ = amplicons
    eng, over = _engine(db_fa, q_fa)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.profiling()
        rows = _run(eng, q_fa, over)
    assert not obs.profiling()
    assert rows
    ranges = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("usearch."):
            ranges[e.name()[len("usearch."):]].append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    st = eng.dev_stats
    assert set(ranges) == set(ENGINE_STAGES) | {"rank_prepare",
                                                "rank_finish"}
    for name, rs in ranges.items():
        assert len(rs) == st[name + "_n"] > 0, name
        assert st[name + "_ns"] > 0, name
    assert len(ranges["request"]) == 1
    # 240 queries in windows of 64
    assert len(ranges["rank"]) == len(ranges["emit"]) == 4
    for name, rs in ranges.items():
        if name != "request":
            assert all(_inside(r, ranges["request"]) for r in rs), name
        if name.startswith("rank_"):
            assert all(_inside(r, ranges["rank"]) for r in rs), name
    for name in ("chain", "holes", "replay"):
        assert all(_inside(r, ranges["round"]) for r in ranges[name]), name
        assert not any(_inside(r, ranges["rank"]) for r in ranges[name])


def test_untraced_run_enters_no_range_and_makes_no_event(amplicons,
                                                         monkeypatch):
    db_fa, q_fa, n_q = amplicons

    def refuse(*_a, **_k):
        raise AssertionError("entered with the profiler off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    eng, over = _engine(db_fa, q_fa)
    assert _run(eng, q_fa, over)
    st = eng.dev_stats
    assert st["request_n"] == 1 and st["queries"] == n_q
    for name in ENGINE_STAGES + ("rank_prepare", "rank_finish"):
        assert st[name + "_n"] > 0 and st[name + "_ns"] > 0, name
    # on the CPU the device half is timed on the host clock, a chunk at a
    # time
    assert st["rank_device_n"] == st["rank_chunks"] > 0
    assert st["rank_device_ns"] > 0
    assert st["rank_hit_slots"] >= 64 * st["rank_chunks"]
    # a CUDA timer off the profiler makes no event and reads nothing
    timer = obs.DeviceTimer(torch.device("cuda"), on=False)
    timer.start()
    timer.stop()
    assert timer.ns() is None


def test_counters_equal_the_candidate_loop(amplicons):
    db_fa, q_fa, n_q = amplicons
    eng, over = _engine(db_fa, q_fa)
    seen = []
    chain = eng._chain_round

    def chain_round(sc, jbuf, j_off, pair_j, pair_t):
        seen.append(len(pair_j))
        return chain(sc, jbuf, j_off, pair_j, pair_t)
    eng._chain_round = chain_round
    _run(eng, q_fa, over)
    st = eng.dev_stats
    assert st["queries"] == n_q
    assert st["pairs"] == sum(seen) >= n_q
    assert st["round_n"] == len(seen) == st["chain_n"] == st["replay_n"]
    # the file's parse, then each of the 4 windows' jobs
    assert st["parse_n"] == 5 and st["rank_n"] == 4
    assert st["rank_device_jobs"] == n_q
    # a second request adds the same counts again
    before = dict(st)
    _run(eng, q_fa, over)
    for k in ("queries", "pairs", "round_n", "chain_n", "rank_chunks",
              "rank_hit_slots", "rank_device_n"):
        assert st[k] == 2 * before[k], k


def test_counters_exact_with_windows_on_threads(amplicons):
    """Windows of 8 queries on 8 threads, with the interpreter switching
    threads every microsecond, count what one thread counts."""
    db_fa, q_fa, n_q = amplicons
    keys = ("queries", "pairs", "host_cells") + tuple(
        s + "_n" for s in ENGINE_STAGES)
    eng1, _ = _engine(db_fa, q_fa, threads=1, ranker=False)
    rows1 = _run(eng1, q_fa, None, window=8)
    want = {k: eng1.dev_stats[k] for k in keys}
    assert want["queries"] == n_q and want["rank_n"] == n_q // 8
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            eng8, _ = _engine(db_fa, q_fa, threads=8, ranker=False)
            assert _run(eng8, q_fa, None, window=8) == rows1
            assert {k: eng8.dev_stats[k] for k in keys} == want
    finally:
        sys.setswitchinterval(interval)


def test_host_cli_counts_its_stages_without_torch(tmp_path):
    """`usearch_global` of amplicon reads (substitutions only: the holes
    stay in the host's chain stage), in a process where torch cannot be
    imported, writes the stage totals on its USEARCH_DEVICE_STATS line."""
    recs = make_amplicons(n_templates=30, reads_per_template=4, length=200,
                          seed=37, max_indels=0)
    db_fa, q_fa = str(tmp_path / "db.fa"), str(tmp_path / "q.fa")
    write_fasta(db_fa, [r for r in recs if r[0].startswith("tpl")])
    write_fasta(q_fa, [r for r in recs if not r[0].startswith("tpl")])
    n_q = 120
    stats = tmp_path / "stats.jsonl"
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from usearch12_tpu_torch.cli import main\n"
            f"assert main(['-usearch_global', {q_fa!r}, '-db', {db_fa!r}, "
            "'-id', '0.9', '-strand', 'plus', '-blast6out', 'h.b6', "
            "'-quiet']) == 0\n"
            "assert sys.modules['torch'] is None\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=ROOT,
                                USEARCH_DEVICE_STATS=str(stats)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = json.loads(stats.read_text().splitlines()[-1])
    assert line["queries"] == n_q and line["request_n"] == 1
    assert line["pairs"] >= n_q and line["round_n"] == line["chain_n"] > 0
    for s in ENGINE_STAGES:
        assert s + "_ns" in line and s + "_n" in line
    assert line["chain_ns"] > 0 and line["emit_ns"] > 0
