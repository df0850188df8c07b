"""The chain's split on the CPU (engine/batch.py: _chain_round): a round's
pairs cut at job boundaries into slices, each chained on a scratch of its
own and appended into the window's plan, give the bytes of one
chain_batch_c call over the round; and run_file writes the same blast6
bytes under -threads 1 and -threads 4, splitting rounds where windows run
one after another and never where the window pool runs them.

The data is the benchmark's rrn_operon configuration at full operon
length, cut to 3 genera of 2 species (12 targets), and Nanopore reads of
its held-out species (benchmark/generators/operons.py, ont.py), each
after a 253-letter piece of another read, so that every slice chains a
query 4 kb longer than the one before it."""

import io
import json
import os

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark.generators import ont, operons
from usearch12_tpu_torch.cli import parse_argv
from usearch12_tpu_torch.engine import batch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
OPTS = ["-id", "0.5", "-strand", "plus", "-maxaccepts", "2",
        "-maxrejects", "4", "-band", "16", "-quiet"]
SEG_KINDS = 5
SEG_LIT = 4     # a literal segment (native/usearch_engine.c)


@pytest.fixture(scope="module")
def operon_set(tmp_path_factory):
    """(db FASTA, query FASTA, records): 12 operons, and 10 reads each
    after a short piece of another read."""
    d = tmp_path_factory.mktemp("chain_split")
    with open(os.path.join(BENCH, "configs", "rrn_operon.json")) as f:
        spec = json.load(f)["reference"]
    with open(os.path.join(BENCH, "traffic", "rrn_novel.json")) as f:
        qspec = json.load(f)["query"]
    spec.update(genera=3, species=2, copies=2)
    ref = operons.reference(spec, gen.rng_for(2 ** 31 + 77, 1))
    reads, _ = ont.queries(qspec, ref, 10, gen.rng_for(2 ** 31 + 77, 2))
    seqs = []
    for i, r in enumerate(reads):
        lo = 300 * i
        seqs += [reads[-1 - i][lo:lo + 253], r]
    db, q = str(d / "db.fa"), str(d / "q.fa")
    gen.write_fasta(db, ref["labels"], ref["seqs"])
    gen.write_fasta(q, [f"o{i}" for i in range(len(seqs))], seqs)
    return db, q, len(seqs)


def _engine(db, q, threads):
    from usearch12_tpu_torch.io.seqdb import SeqDB
    parse_argv(["-usearch_global", q, "-db", db, "-threads", str(threads)]
               + OPTS)
    sdb = SeqDB.from_fastx(db)
    sdb.mask()
    return batch.BatchEngine("usearch_global", sdb)


def _round(eng, q):
    """A round of every job's every candidate: (jbuf, j_off, pair_j,
    pair_t)."""
    win = batch._FastaWindows(q)
    jbuf = np.ascontiguousarray(win.seq_buf[:win.seq_off[win.n]])
    j_off = win.seq_off[:win.n + 1].astype(np.int64)
    cand, _, out_n = eng._rank_jobs(jbuf, j_off)
    pair_j = np.repeat(np.arange(win.n), out_n).astype(np.int32)
    within = np.concatenate([np.arange(n) for n in out_n])
    pair_t = np.ascontiguousarray(cand[pair_j, within])
    return jbuf, j_off, pair_j, pair_t


def _plan(eng, sc, res, n_pairs):
    """The plan's arrays up to their used lengths."""
    status, pso, n_hole = res
    n_seg = int(pso[n_pairs])
    n_lit = eng.lib.chain_plan_lit_bytes(
        sc.seg_kind.ctypes.data, sc.seg_val.ctypes.data,
        sc.seg_val2.ctypes.data, n_seg)
    out = {"status": status, "pair_seg_off": pso[:n_pairs + 1],
           "n_hole": np.array([n_hole]), "lit_buf": sc.lit_buf[:n_lit]}
    for name in ("seg_kind", "seg_val", "seg_val2"):
        out[name] = getattr(sc, name)[:n_seg]
    for name in ("hole_pair", "hole_aoff", "hole_boff", "hole_alen",
                 "hole_blen", "hole_cls"):
        out[name] = getattr(sc, name)[:n_hole]
    return {k: v.copy() for k, v in out.items()}


@pytest.mark.parametrize("n_slices", [1, 2, 3, 5])
def test_split_round_equals_one_call(operon_set, n_slices):
    db, q, n_reads = operon_set
    eng = _engine(db, q, 8)
    jbuf, j_off, pair_j, pair_t = _round(eng, q)
    n_pairs = len(pair_j)
    one = _plan(eng, eng._sc, eng._chain_call(eng._sc, jbuf, j_off, pair_j,
                                         pair_t), n_pairs)
    # holes above dev_min_cells (the ITS) and below it (inline literals)
    assert one["n_hole"][0] > 0
    assert (one["seg_kind"] == SEG_LIT).sum() > 0
    assert one["seg_kind"].max() < SEG_KINDS
    cuts = eng._slice_cuts(j_off, pair_j, pair_t, n_slices)
    assert len(cuts) == n_slices + 1 and cuts[0] == 0 \
        and cuts[-1] == n_pairs
    # cut at job boundaries only
    assert all(pair_j[c] != pair_j[c - 1] for c in cuts[1:-1])
    # a slice's scratch small enough that its first call takes each
    # capacity retry, and a window's scratch that must grow for the merge
    while len(eng._slice_sc) < n_slices:
        eng._slice_sc.append(eng._new_scratch())
    tiny = eng._slice_sc[n_slices - 1]
    tiny.seg_cap, tiny.hole_cap, tiny.lit_cap = 4, 1, 16
    tiny.alloc_round_bufs()
    sc = eng._new_scratch()
    sc.seg_cap, sc.hole_cap, sc.lit_cap = 4, 1, 16
    sc.alloc_round_bufs()
    res = (eng._chain_split(sc, jbuf, j_off, pair_j, pair_t, cuts)
           if n_slices > 1 else eng._chain_call(sc, jbuf, j_off, pair_j,
                                                 pair_t))
    assert min(tiny.seg_cap, tiny.hole_cap, tiny.lit_cap) > 16 \
        or n_slices == 1
    split = _plan(eng, sc, res, n_pairs)
    for k, v in one.items():
        assert split[k].dtype == v.dtype and split[k].tobytes() == \
            v.tobytes(), k
    # the round again on the same scratches: what stays in them from the
    # first round changes nothing
    again = _plan(eng, sc, eng._chain_split(sc, jbuf, j_off, pair_j, pair_t,
                                       cuts) if n_slices > 1 else
                  eng._chain_call(sc, jbuf, j_off, pair_j, pair_t), n_pairs)
    assert all(again[k].tobytes() == v.tobytes() for k, v in one.items())


def test_rounds_back_to_back_on_one_engine(operon_set):
    """Thirty rounds on one engine, of 2, 5 and twice the cores' slices in
    turn (more threads than cores), each of all the jobs or of the jobs
    from the third on: every plan the bytes of one call over its round."""
    db, q, _ = operon_set
    eng = _engine(db, q, 8)
    jbuf, j_off, pair_j, pair_t = _round(eng, q)
    rounds = []
    for lo in (0, int(np.searchsorted(pair_j, 2))):
        pj, pt = pair_j[lo:], pair_t[lo:]
        rounds.append((pj, pt, _plan(eng, eng._sc, eng._chain_call(
            eng._sc, jbuf, j_off, pj, pt), len(pj))))
    sc = eng._new_scratch()
    for i in range(30):
        pj, pt, one = rounds[i % 2]
        cuts = eng._slice_cuts(j_off, pj, pt, (2, 5, 2 * batch._cores())[
            i % 3])
        got = _plan(eng, sc, eng._chain_split(sc, jbuf, j_off, pj, pt,
                                              cuts), len(pj))
        assert all(got[k].tobytes() == v.tobytes() for k, v in one.items()), i


def _run_file(db, q, threads, window, override, stats, monkeypatch):
    from usearch12_tpu_torch.engine.emit import Blast6Emitter
    from usearch12_tpu_torch.ops.csr_rank import (CSRDeviceRanker,
                                                  make_engine_override)
    eng = _engine(db, q, threads)
    over = make_engine_override(
        CSRDeviceRanker(eng.index, torch.device("cpu")), eng) \
        if override else None
    em = Blast6Emitter(io.StringIO(), eng.db, True)
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    eng.run_file(q, None, window=window, fast_emit=em, rank_override=over)
    monkeypatch.delenv("USEARCH_DEVICE_STATS")
    return em.f.getvalue(), json.loads(stats.read_text().splitlines()[-1])


@pytest.mark.parametrize("override", [False, True])
def test_run_file_bytes_under_threads(operon_set, override, tmp_path,
                                      monkeypatch):
    db, q, n_reads = operon_set
    # the test's rounds are small: a slice a 2,000 letters
    monkeypatch.setattr(batch, "SLICE_MIN_LETTERS", 2000)
    one, ds1 = _run_file(db, q, 1, 8192, override, tmp_path / "t1",
                         monkeypatch)
    four, ds4 = _run_file(db, q, 4, 8192, override, tmp_path / "t4",
                          monkeypatch)
    assert one == four and len(one.splitlines()) >= n_reads
    assert ds1["chain_split_rounds"] == ds1["chain_slices"] == 0
    assert 0 < ds4["chain_split_rounds"] <= ds4["round_n"]
    assert 2 * ds4["chain_split_rounds"] <= ds4["chain_slices"] \
        <= 4 * ds4["chain_split_rounds"]
    assert ds1["pairs"] == ds4["pairs"] and ds1["round_n"] == ds4["round_n"]
    if not override:
        # windows of 4 records on the window pool: no round is split
        pool, ds = _run_file(db, q, 4, 4, False, tmp_path / "w4",
                             monkeypatch)
        assert pool == one
        assert ds["chain_split_rounds"] == ds["chain_slices"] == 0


def test_slice_count_follows_the_cores(operon_set, monkeypatch):
    """Left to itself a round takes at most a slice a core, even under
    -threads above the cores, and one on a window-pool thread."""
    db, q, _ = operon_set
    eng = _engine(db, q, 64)
    jbuf, j_off, pair_j, pair_t = _round(eng, q)
    monkeypatch.setattr(batch, "SLICE_MIN_LETTERS", 1)
    n_jobs = len(np.unique(pair_j))
    assert len(eng._slice_cuts(j_off, pair_j, pair_t)) - 1 == \
        min(batch._cores(), n_jobs)
    eng._tls.window_pool = True
    assert len(eng._slice_cuts(j_off, pair_j, pair_t)) == 2


def test_pool_threads_end_with_their_engine(operon_set):
    """The chain pool's threads, a core each but the caller's, made at the
    first split; once the engine goes, so do they."""
    import gc
    import weakref

    def n_threads():
        return len(os.listdir("/proc/self/task"))
    db, q, _ = operon_set
    before = n_threads()
    eng = _engine(db, q, 8)
    jbuf, j_off, pair_j, pair_t = _round(eng, q)
    assert n_threads() == before
    eng._chain_split(eng._sc, jbuf, j_off, pair_j, pair_t,
                     eng._slice_cuts(j_off, pair_j, pair_t, 5))
    assert n_threads() == before + min(8, batch._cores()) - 1
    gone = weakref.ref(eng)
    del eng
    gc.collect()
    assert gone() is None and n_threads() == before
