"""The -sintax command kept loaded (amplicon/sintax.py:SintaxRun) on the
CPU: each classify_file() call writes the bytes of one fresh sintax
command on the same database and query file, on the host path and on the
card's path (the kernels' plain versions), also call after call (the
tie-break RNG restarts at -randseed); and its spans and counters count what
the windows do.  The database holds exact and near duplicates under
different genera, so that boots tie and the tie-break shows in the rows."""

import io

import numpy as np
import pytest
import torch

import usearch12_tpu_torch.cli as port_cli
from usearch12_tpu_torch.amplicon.sintax import WINDOW, SintaxRun
from usearch12_tpu_torch.cli import parse_argv
from usearch12_tpu_torch.config import options

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = {ord("A"): "T", ord("C"): "G", ord("G"): "C", ord("T"): "A"}


def _write(path, recs):
    with open(path, "w") as f:
        for label, s in recs:
            f.write(f">{label}\n{s}\n")


def _data(d, seed, n_q=560):
    """db.fa: 20 templates of 200 nt, each with an exact copy and a copy
    one substitution away, the three in different genera of one family;
    q1.fa, q2.fa: n_q reads of 40-150 nt cut from the targets with 0-3
    substitutions, every fourth reverse-complemented, two of 10 nt (fewer
    than 8 unique words)."""
    rng = np.random.default_rng(seed)
    targets = []
    for g in range(20):
        tpl = ACGT[rng.integers(0, 4, 200)]
        for k in range(3):
            s = tpl.copy()
            if k == 2:
                p = rng.integers(0, 200)
                s[p] = ACGT[(np.searchsorted(ACGT, s[p]) + 1) % 4]
            targets.append((f"t{g}_{k};tax=d:D{g % 2},p:P{g % 4},"
                            f"f:F{g},g:G{g}_{k};", s.tobytes().decode()))
    _write(str(d / "db.fa"), targets)
    for name in ("q1.fa", "q2.fa"):
        recs = []
        for i in range(n_q):
            s = bytearray(targets[rng.integers(0, len(targets))][1].encode())
            n = 10 if i in (3, 300) else int(rng.integers(40, 151))
            lo = int(rng.integers(0, len(s) - n + 1))
            s = s[lo:lo + n]
            for p in rng.integers(0, n, rng.integers(0, 4)):
                s[p] = ACGT[rng.integers(0, 4)]
            q = bytes(s).decode()
            if i % 4 == 0:
                q = q[::-1].translate(COMP)
            recs.append((f"q{i}", q))
        _write(str(d / name), recs)
    return str(d / "db.fa"), str(d / "q1.fa"), str(d / "q2.fa")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _data(tmp_path_factory.mktemp("resident"), 5)


def _argv(db, flag, strand="both"):
    return ["-db", db, "-strand", strand, "-boots", "10", "-quiet",
            "-randseed", "3", flag]


def _command(tmp_path, q, argv, device="cpu"):
    """The bytes of one fresh sintax command."""
    out = str(tmp_path / "cmd.txt")
    assert port_cli.main(["-sintax", q, "-tabbedout", out] + argv,
                         device=device) == 0
    with open(out, "rb") as f:
        return f.read()


def _resident(argv, calls, device=CPU):
    """A SintaxRun on `device`; the bytes of each call on calls' files, in
    turn, and the run."""
    parse_argv(argv)
    run = SintaxRun(device)
    got = []
    for q in calls:
        out = io.StringIO()
        n = run.classify_file(q, out)
        assert n == out.getvalue().count("\n")
        got.append(out.getvalue().encode())
    return got, run


@pytest.mark.parametrize("strand", ["both", "plus"])
@pytest.mark.parametrize("flag", ["-no_sintax_device", "-sintax_device"])
def test_each_call_writes_a_fresh_commands_bytes(files, tmp_path, flag,
                                                 strand):
    db, q1, q2 = files
    argv = _argv(db, flag, strand)
    got, run = _resident(argv, [q1, q2, q1])
    assert run.on_card == (flag == "-sintax_device") and run.windowed
    want1, want2 = (_command(tmp_path, q, argv) for q in (q1, q2))
    assert got == [want1, want2, want1]
    assert want1 != want2 and want1.count(b"\n") == 560
    # ties broken differently show: the rows depend on the seed
    assert _command(tmp_path, q1, argv[:-2] + ["7", flag]) != want1


def test_counters_count_the_windows(files):
    db, q1, _ = files
    argv = _argv(db, "-sintax_device")
    _, run = _resident(argv, [q1])
    params = run.cls.index.params
    from usearch12_tpu_torch.alpha import revcomp
    from usearch12_tpu_torch.io.fastx import read_fastx
    seqs = [s for _, s, _ in read_fastx(q1)]
    windows = [seqs[lo:lo + WINDOW] for lo in range(0, len(seqs), WINDOW)]
    jobs = [[len(params.unique_words(x)) for s in w for x in (s, revcomp(s))
             if len(params.unique_words(x)) >= 8] for w in windows]
    st = run.dev_stats
    assert len(windows) == 2 and sum(map(len, jobs)) < 2 * len(seqs)
    assert st["sintax_queries"] == len(seqs)
    assert st["sintax_jobs"] == sum(map(len, jobs))
    assert st["sintax_words"] == sum(map(sum, jobs))
    assert st["sintax_chunks"] == sum(-(-len(j) // 128) for j in jobs)
    # one span a window; the parse span also reads the file's end
    assert st["sintax_parse_n"] == len(windows) + 1
    for name in ("sintax_prepare", "sintax_draws", "sintax_boots",
                 "sintax_tally"):
        assert st[name + "_n"] == len(windows)
        assert st[name + "_ns"] > 0
    assert st["sintax_draws_ns"] < st["sintax_prepare_ns"]
    # on the CPU the boots' device time is the host clock around each chunk
    assert st["sintax_boot_device_n"] == st["sintax_chunks"]
    assert st["sintax_launches"] == 0      # the plain versions launch none
    # one native call of the draws a window
    assert st["sintax_draws_native"] == len(windows)
    # one native call of the tally and vote a window
    assert st["sintax_tally_native"] == len(windows)
    # a second call adds as much again
    before = dict(st)
    run.classify_file(q1, None)
    assert {k: st[k] - before[k] for k in ("sintax_queries", "sintax_jobs",
                                           "sintax_chunks")} == \
        {k: before[k] for k in ("sintax_queries", "sintax_jobs",
                                "sintax_chunks")}
    assert st["sintax_draws_native"] == 2 * len(windows)
    assert st["sintax_tally_native"] == 2 * len(windows)


def test_host_path_counts_parse_tally_and_queries(files):
    db, q1, _ = files
    _, run = _resident(_argv(db, "-no_sintax_device"), [q1])
    st = run.dev_stats
    assert st["sintax_queries"] == 560
    assert (st["sintax_parse_n"], st["sintax_tally_n"]) == (3, 2)
    assert not any(k.startswith(("sintax_boots", "sintax_jobs"))
                   for k in st)


def test_profiler_sees_the_spans(files, tmp_path):
    """While torch.profiler records, each span is a usearch.* range, the
    draws inside the preparation."""
    db, q1, _ = files
    q = str(tmp_path / "q.fa")
    with open(q1) as f, open(q, "w") as g:
        g.writelines(f.readlines()[:200])
    parse_argv(_argv(db, "-sintax_device"))
    run = SintaxRun(CPU)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.classify_file(q, None)
    ranges = {}
    for e in prof.events():
        if e.name.startswith("usearch.sintax_"):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    st = run.dev_stats
    for name in ("parse", "prepare", "draws", "boots", "tally"):
        assert len(ranges["usearch.sintax_" + name]) == \
            st[f"sintax_{name}_n"]
    for s, e in ranges["usearch.sintax_draws"]:
        assert any(ps <= s and e <= pe
                   for ps, pe in ranges["usearch.sintax_prepare"])
    assert options().flag("sintax_device")
