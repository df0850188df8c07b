"""usearch12_tpu_torch's CSR ranker (ops/csr_rank.py) and -device_rank on
the CPU, where the ranker's torch ops run on CPU tensors.

At or below -big the port's ranker is held to the JAX package's
CSRDeviceRanker; above it, where the reference ranks with UDBSearchBig, to
the port's host big-mode rankers (search/usorted.py:_rank_big_py and the
big branch of the C ranker), which the first test holds to each other.
The command line with -device_rank writes the bytes of -no_device_rank
and of the JAX CLI's host path.  Tolerance 0: every compared value is an
integer or a byte."""

import json
import os

import numpy as np
import pytest
import torch

import usearch12_tpu.cli as jax_cli
import usearch12_tpu_torch.cli as port_cli
from tests.genseqs import make_amplicons, write_fasta
from usearch12_tpu_torch import commands as port_commands
from usearch12_tpu_torch import runlog as port_runlog
from usearch12_tpu_torch.ops import csr_rank

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ranked_db(tmp_path_factory):
    """tests/test_csr_rank.py's fixture: 80 templates as the DB, their 320
    reads as the queries."""
    d = tmp_path_factory.mktemp("csr")
    recs = make_amplicons(n_templates=80, reads_per_template=4, length=200,
                          seed=41)
    db_fa, q_fa = str(d / "db.fa"), str(d / "q.fa")
    write_fasta(db_fa, [r for r in recs if r[0].startswith("tpl")])
    write_fasta(q_fa, [r for r in recs if not r[0].startswith("tpl")])
    return db_fa, q_fa


@pytest.fixture(scope="module")
def big_db(tmp_path_factory):
    """300 targets (templates and reads of 60 clusters) and 100 queries
    from the same clusters, for -big 10."""
    d = tmp_path_factory.mktemp("csr_big")
    recs = make_amplicons(n_templates=80, reads_per_template=4, length=200,
                          seed=43)
    db_fa, q_fa = str(d / "db.fa"), str(d / "q.fa")
    write_fasta(db_fa, recs[:300])
    write_fasta(q_fa, recs[300:])
    return db_fa, q_fa


def _port_setup(db_fa, q_fa, extra=()):
    """The port's options for a search of q_fa against db_fa, its index and
    the queries as one window of jobs (jbuf, j_off)."""
    from usearch12_tpu_torch.index.udb import UDBIndex
    from usearch12_tpu_torch.io.fastx import read_fastx
    from usearch12_tpu_torch.io.seqdb import SeqDB
    port_cli.parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                         "-strand", "plus", "-quiet", *extra])
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    index = UDBIndex.from_seqdb(db)
    seqs = [s for _l, s, _q in read_fastx(q_fa, stream=True)]
    jbuf = np.ascontiguousarray(np.concatenate(seqs))
    j_off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=j_off[1:])
    return db, index, seqs, jbuf, j_off


def _jax_rank(db_fa, q_fa, extra, jbuf, j_off):
    """The JAX package's CSRDeviceRanker on the same window."""
    from usearch12_tpu.index.udb import UDBIndex
    from usearch12_tpu.io.seqdb import SeqDB
    from usearch12_tpu.ops.csr_rank import CSRDeviceRanker
    jax_cli.parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                        "-strand", "plus", "-quiet", *extra])
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    return CSRDeviceRanker(UDBIndex.from_seqdb(db), topk=64,
                           chunk_b=64).rank_window(jbuf, j_off)


@pytest.mark.parametrize("stepwords", ["0", "8"])
@pytest.mark.parametrize("fract_id", ["0.5", "0.8", "0.97"])
def test_host_big_rankers_agree(big_db, fract_id, stepwords):
    """The port's two host judges of big mode (UDBSearchBig): _rank_big_py
    and the big branch of the C ranker (NativeRanker.rank(q, 0, 0), armed
    above -big), on every query of a 300-target DB at -big 10."""
    from usearch12_tpu_torch.search.usorted import USortedRanker
    db_fa, q_fa = big_db
    _db, index, seqs, _jbuf, _j_off = _port_setup(
        db_fa, q_fa, ["-id", fract_id, "-big", "10", "-stepwords",
                      stepwords])
    ranker = USortedRanker(index)
    assert ranker._native is not None
    n_ranked = 0
    for s in seqs:
        uw = index.params.unique_words(s)
        py_t, py_c = ranker._rank_big_py(uw)
        c_t, c_c = ranker._native.rank(s, 0, 0)
        assert np.array_equal(py_t, c_t) and np.array_equal(py_c, c_c)
        n_ranked += len(py_t) > 0
    assert n_ranked == len(seqs)


@pytest.mark.parametrize("bump", [None, "0"])
@pytest.mark.parametrize("big", [None, "80"])
def test_ranker_equals_jax_at_or_below_big(ranked_db, big, bump):
    """80 targets below the default -big and at -big 80 (not above it):
    the port's ranker equals the JAX CSRDeviceRanker in every candidate,
    count, list length and uncertain flag, with -bump 0 and the default."""
    db_fa, q_fa = ranked_db
    extra = (["-big", big] if big else []) + (["-bump", bump] if bump
                                              else [])
    _db, index, _seqs, jbuf, j_off = _port_setup(db_fa, q_fa, extra)
    port = csr_rank.CSRDeviceRanker(index, CPU, topk=64, chunk_b=64)
    assert not port.big
    got = port.rank_window(jbuf, j_off)
    want = _jax_rank(db_fa, q_fa, extra, jbuf, j_off)
    for name, x, y in zip(("cand", "cnts", "out_n", "uncertain"), got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert got[2].min() > 0 and not got[3].any()


def _host_big_lists(index, seqs, K):
    from usearch12_tpu_torch.search.usorted import USortedRanker
    ranker = USortedRanker(index)
    out = []
    for s in seqs:
        py = ranker._rank_big_py(index.params.unique_words(s))
        c = ranker._native.rank(s, 0, 0)
        assert all(np.array_equal(x, y) for x, y in zip(py, c))
        out.append((py[0][:K], py[1][:K]))
    return out


@pytest.mark.parametrize("stepwords", ["0", "8"])
@pytest.mark.parametrize("fract_id", ["0.5", "0.9", "0.97"])
def test_ranker_big_equals_host_big(big_db, fract_id, stepwords):
    """Above -big (300 targets, -big 10): the port's ranker equals the
    host big-mode rankers' lists, cut at K, exactly."""
    db_fa, q_fa = big_db
    _db, index, seqs, jbuf, j_off = _port_setup(
        db_fa, q_fa, ["-id", fract_id, "-big", "10", "-stepwords",
                      stepwords])
    port = csr_rank.CSRDeviceRanker(index, CPU, topk=64, chunk_b=16)
    assert port.big
    cand, cnts, out_n, unc = port.rank_window(jbuf, j_off)
    assert not unc.any()
    for j, (tix, c) in enumerate(_host_big_lists(index, seqs, 64)):
        n = len(tix)
        assert out_n[j] == n, j
        assert np.array_equal(cand[j, :n], tix), j
        assert np.array_equal(cnts[j, :n], c), j


def test_jax_ranker_differs_above_big(big_db):
    """The JAX CSRDeviceRanker ranks with SetTopBump above -big too, where
    the reference uses UDBSearchBig; it differs from the port (and the
    host) on some query, so that nobody moves the port towards it."""
    db_fa, q_fa = big_db
    extra = ["-big", "10"]
    _db, index, seqs, jbuf, j_off = _port_setup(db_fa, q_fa, extra)
    got = csr_rank.CSRDeviceRanker(index, CPU, topk=64).rank_window(
        jbuf, j_off)
    want = _jax_rank(db_fa, q_fa, extra, jbuf, j_off)
    differ = [j for j in range(len(seqs))
              if got[2][j] != want[2][j]
              or not np.array_equal(got[0][j, :got[2][j]],
                                    want[0][j, :want[2][j]])]
    assert differ
    host = _host_big_lists(index, seqs, 64)
    assert all(np.array_equal(got[0][j, :got[2][j]], host[j][0])
               for j in differ)


def _search(run, d, args, outs, stats=None, monkeypatch=None):
    """Output bytes of one usearch_global command line run in directory d
    (relative output names, so that -alnout's header matches)."""
    d.mkdir()
    monkeypatch.chdir(d)
    if stats:
        monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    port_runlog.reset()
    assert run(args + sum(([f"-{o}", o] for o in outs), [])) == 0
    monkeypatch.delenv("USEARCH_DEVICE_STATS", raising=False)
    return {o: (d / o).read_bytes() for o in outs}


def _stats(path):
    with open(path) as f:
        return json.loads(f.read().splitlines()[-1])


OUTS = ["blast6out", "userout", "alnout"]


@pytest.mark.parametrize("stepwords", ["0", "8"])
@pytest.mark.parametrize("bump", [None, "0"])
@pytest.mark.parametrize("big", [None, "10"])
def test_device_rank_cli_bytes(ranked_db, tmp_path, monkeypatch, big, bump,
                               stepwords):
    """usearch_global with -device_rank (the ranker on CPU tensors) writes
    the bytes of -no_device_rank and of the JAX CLI's host path, on both
    sides of -big; every job ranked by the ranker."""
    db_fa, q_fa = ranked_db
    args = ["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9", "-strand",
            "both", "-userfields", "query+target+id+qlo+qhi+tlo+thi",
            "-stepwords", stepwords, "-quiet"]
    args += (["-big", big] if big else []) + (["-bump", bump] if bump
                                              else [])
    stats = tmp_path / "stats.jsonl"
    port = lambda a: port_cli.main(a, device="cpu")  # noqa: E731
    card = _search(port, tmp_path / "card", args + ["-device_rank"], OUTS,
                   stats, monkeypatch)
    ds = _stats(stats)
    assert ds["rank_device_jobs"] == 2 * 320
    assert ds["rank_host_rerank_jobs"] == 0
    host = _search(port, tmp_path / "host", args + ["-no_device_rank"], OUTS,
                   stats, monkeypatch)
    assert _stats(stats)["rank_device_jobs"] == 0
    jax = _search(jax_cli.main, tmp_path / "jax", args + ["-no_device_rank"],
                  OUTS, monkeypatch=monkeypatch)
    # -alnout's first line is the command line, which differs in the flag
    head = [r.pop("alnout").split(b"\n", 1) for r in (card, host, jax)]
    assert head[0][0].replace(b"-device_rank", b"-no_device_rank") == \
        head[1][0] == head[2][0]
    assert head[0][1] == head[1][1] == head[2][1]
    assert card == host == jax
    assert card["blast6out"].count(b"\n") > 100


def test_over_cap_jobs_ranked_on_the_host(ranked_db, monkeypatch):
    """Jobs whose hit stream passes CAP_MAX come back uncertain with no
    candidates, and the engine override ranks exactly those on the host."""
    from usearch12_tpu_torch.engine.batch import BatchEngine
    db_fa, q_fa = ranked_db
    db, index, seqs, jbuf, j_off = _port_setup(db_fa, q_fa)
    monkeypatch.setattr(csr_rank.CSRDeviceRanker, "CAP_MAX", 4)
    ranker = csr_rank.CSRDeviceRanker(index, CPU, topk=64)
    n = 8
    cand, cnts, out_n, unc = ranker.rank_window(jbuf, j_off[:n + 1])
    assert unc.all() and (out_n == 0).all()
    eng = BatchEngine("usearch_global", db, index=index)
    o_cand, o_cnts, o_out_n = csr_rank.make_engine_override(ranker, eng)(
        jbuf, j_off[:n + 1])
    assert eng.dev_stats["rank_host_rerank_jobs"] == n
    h_cand, h_cnts, h_out_n = eng._rank_jobs(jbuf, j_off[:n + 1])
    assert np.array_equal(o_out_n, h_out_n)
    for j in range(n):
        k = int(h_out_n[j])
        assert np.array_equal(o_cand[j, :k], h_cand[j, :k])
        assert np.array_equal(o_cnts[j, :k], h_cnts[j, :k])


def test_over_cap_cli_counts_host_reranks(ranked_db, tmp_path, monkeypatch):
    """The command line with a CAP_MAX that some queries pass: the bytes
    of the host path, and the counter shows the jobs the host ranked."""
    db_fa, q_fa = ranked_db
    args = ["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9", "-strand",
            "plus", "-quiet"]
    port = lambda a: port_cli.main(a, device="cpu")  # noqa: E731
    host = _search(port, tmp_path / "host", args + ["-no_device_rank"],
                   ["blast6out"], monkeypatch=monkeypatch)
    # the command's ranker is the host half on the card's device half
    monkeypatch.setattr(csr_rank.CSRRanker, "CAP_MAX", 200)
    stats = tmp_path / "stats.jsonl"
    card = _search(port, tmp_path / "card", args + ["-device_rank"],
                   ["blast6out"], stats, monkeypatch)
    ds = _stats(stats)
    assert card == host
    assert ds["rank_device_jobs"] == 320
    assert 0 < ds["rank_host_rerank_jobs"] < 320


@pytest.mark.parametrize("flag,gate,engaged", [
    (None, 80, True), ("-no_device_rank", 80, False),
    ("-no_engine_device", 80, False), (None, None, False)])
def test_auto_gate(ranked_db, tmp_path, monkeypatch, flag, gate, engaged):
    """With AUTO_MIN_RANK_TARGETS at or below the DB's 80 targets, the
    ranker engages when the engine has a device, and not under
    -no_device_rank or -no_engine_device; with the gate off (None) only
    -device_rank takes it.  The bytes stay the host's."""
    db_fa, q_fa = ranked_db
    args = ["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9", "-strand",
            "plus", "-quiet"]
    port = lambda a: port_cli.main(a, device="cpu")  # noqa: E731
    host = _search(port, tmp_path / "host", args + ["-no_device_rank",
                                                    "-no_engine_device"],
                   ["blast6out"], monkeypatch=monkeypatch)
    assert port_commands.AUTO_MIN_RANK_TARGETS == 220000
    monkeypatch.setattr(port_commands, "AUTO_MIN_RANK_TARGETS", gate)
    stats = tmp_path / "stats.jsonl"
    got = _search(port, tmp_path / "auto", args + ([flag] if flag else []),
                  ["blast6out"], stats, monkeypatch)
    assert got == host
    assert _stats(stats)["rank_device_jobs"] == (320 if engaged else 0)


def test_device_rank_needs_a_card_unless_cpu_is_passed(ranked_db, tmp_path,
                                                       monkeypatch):
    """-device_rank ranks on the card even with -no_engine_device, and
    raises without one when no device is passed."""
    db_fa, q_fa = ranked_db
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                       "-strand", "plus", "-quiet", "-no_engine_device",
                       "-device_rank", "-blast6out",
                       str(tmp_path / "x.b6")])


@pytest.mark.parametrize("stepwords", ["0", "8"])
@pytest.mark.parametrize("big", [None, "10"])
def test_window_as_one_chunk_equals_chunks_of_64(big_db, big, stepwords):
    """A window ranked as one chunk (chunk_b = WINDOW, the kernel route's
    chunking) through the torch ops gives rank_window's output of chunks
    of 64 queries, on both sides of -big."""
    db_fa, q_fa = big_db
    extra = (["-big", big] if big else []) + ["-stepwords", stepwords]
    _db, index, _seqs, jbuf, j_off = _port_setup(db_fa, q_fa, extra)
    window = csr_rank.CSRDeviceRanker(index, CPU,
                                      chunk_b=csr_rank.CSRRanker.WINDOW)
    n_jobs, chunks, _over = window.prepare_chunks(jbuf, j_off)
    assert len(chunks) == 1 and chunks[0][2].shape[0] == n_jobs == 100
    got = window.rank_window(jbuf, j_off)
    chunked = csr_rank.CSRDeviceRanker(index, CPU, chunk_b=64)
    assert chunked.chunk_b == 64 and window.big == (big is not None)
    want = chunked.rank_window(jbuf, j_off)
    for name, x, y in zip(("cand", "cnts", "out_n", "uncertain"), got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert window.stats["rank_chunks"] == 1
    assert chunked.stats["rank_chunks"] == 2


def _hit_streams(ranker, jbuf, j_off):
    """Each job's hit stream in numpy: its words' posting rows end to
    end, as prepare_chunks picks the words."""
    starts, sizes, post = ranker.csr_arrays()
    _n, chunks, _over = ranker.prepare_chunks(jbuf, j_off)
    out = []
    for lo, hi, qw, _cap in chunks:
        for row in qw[:hi - lo]:
            out.append(np.concatenate(
                [post[starts[w]:starts[w] + sizes[w]] for w in row]))
    return out


@pytest.mark.parametrize("chunk_b", [64, 0])
@pytest.mark.parametrize("fract_id", ["0.5", "0.97"])
def test_rank_touched_counts_distinct_targets(big_db, fract_id, chunk_b):
    """rank_touched equals the distinct targets a numpy count of the same
    hit streams finds, summed over the queries (UDBSearchBig)."""
    db_fa, q_fa = big_db
    _db, index, _seqs, jbuf, j_off = _port_setup(
        db_fa, q_fa, ["-id", fract_id, "-big", "10"])
    ranker = csr_rank.CSRDeviceRanker(index, CPU, chunk_b=chunk_b)
    streams = _hit_streams(ranker, jbuf, j_off)
    assert len(streams) == 100 and sum(map(len, streams)) > 0
    ranker.rank_window(jbuf, j_off)
    assert ranker.stats["rank_touched"] == sum(len(np.unique(s))
                                               for s in streams)
    assert "rank_kernel_launches" not in ranker.stats


def test_over_cap_rerank_at_window_chunks(big_db, monkeypatch):
    """Above -big with the window as one chunk and a CAP_MAX that some
    jobs pass: exactly those come back uncertain, the override ranks them
    as the host does, and its lists equal those of chunks of 64."""
    from usearch12_tpu_torch.engine.batch import BatchEngine
    db_fa, q_fa = big_db
    db, index, _seqs, jbuf, j_off = _port_setup(db_fa, q_fa, ["-big", "10"])
    probe = csr_rank.CSRDeviceRanker(index, CPU)
    totals = np.array([len(s) for s in _hit_streams(probe, jbuf, j_off)])
    cap_max = int(np.median(totals))
    monkeypatch.setattr(csr_rank.CSRDeviceRanker, "CAP_MAX", cap_max)
    over = totals > cap_max
    assert 0 < over.sum() < len(totals)
    outs = []
    for chunk_b in (csr_rank.CSRRanker.WINDOW, 64):
        ranker = csr_rank.CSRDeviceRanker(index, CPU, chunk_b=chunk_b)
        _cand, _cnts, out_n, unc = ranker.rank_window(jbuf, j_off)
        assert np.array_equal(unc & over, over) and (out_n[over] == 0).all()
        eng = BatchEngine("usearch_global", db, index=index)
        outs.append(csr_rank.make_engine_override(ranker, eng)(jbuf, j_off))
        assert eng.dev_stats["rank_host_rerank_jobs"] == unc.sum()
    for x, y in zip(*outs):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    redo = np.nonzero(over)[0]
    parts = [jbuf[j_off[j]:j_off[j + 1]] for j in redo]
    sub_off = np.zeros(len(redo) + 1, np.int64)
    np.cumsum([len(x) for x in parts], out=sub_off[1:])
    h_cand, h_cnts, h_out_n = eng._rank_jobs(np.concatenate(parts), sub_off)
    o_cand, o_cnts, o_out_n = outs[0]
    assert np.array_equal(o_out_n[redo], h_out_n)
    for r, j in enumerate(redo):
        k = int(h_out_n[r])
        assert np.array_equal(o_cand[j, :k], h_cand[r, :k]), j
        assert np.array_equal(o_cnts[j, :k], h_cnts[r, :k]), j


@pytest.mark.parametrize("smem_hits", [0, 40, 10 ** 9])
def test_kernel_meta_places_device_memory_tables(big_db, monkeypatch,
                                                 smem_hits):
    """csr_rank_big's input: each row's words, then for a query above
    SMEM_HITS hits its table's offset and size (a power of two of at
    least twice its hits), the tables packed into one buffer of
    spill_total slots for the chunk's one launch."""
    db_fa, q_fa = big_db
    _db, index, _seqs, jbuf, j_off = _port_setup(db_fa, q_fa, ["-big", "10"])
    ranker = csr_rank.CSRDeviceRanker(index, CPU)
    _n, chunks, _over = ranker.prepare_chunks(jbuf, j_off)
    qw, cap = chunks[0][2], chunks[0][3]
    monkeypatch.setattr(csr_rank, "SMEM_HITS", smem_hits)
    meta, spill_total, spills = ranker.dev.kernel_meta(qw, cap)
    B, wmax = qw.shape
    assert np.array_equal(meta[:, :wmax], qw)
    hits = np.minimum(ranker._sizes_np[qw].sum(1), cap)
    spill = hits > smem_hits
    assert spills == spill.sum()
    off, slots = meta[:, wmax], meta[:, wmax + 1]
    assert (slots[~spill] == 0).all() and (off[~spill] == 0).all()
    assert (slots[spill] >= 2 * hits[spill]).all()
    assert (slots[spill] < 4 * np.maximum(hits[spill], 1)).all()
    assert all(s & (s - 1) == 0 for s in slots[spill])
    assert spill_total == slots.sum()
    assert np.array_equal(off[spill], np.cumsum(slots[spill])
                          - slots[spill])
    if smem_hits == 0:
        assert spills == B
    if spills == 0:
        assert spill_total == 0
