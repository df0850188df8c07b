"""usearch_global on rrn operon reads through the port on the CPU: the
hole DP's holes, aligned by the kernels' plain versions on a CPU card,
against the benchmark's plain reference (benchmark/reference/holes.py),
and the dispatch gate of an engine that holds a cold card.

The data is the benchmark's rrn_operon configuration at full operon
length, cut to 3 genera of 2 species (12 targets), and 8 Nanopore reads
of the held-out species (benchmark/generators/operons.py, ont.py)."""

import json
import os

import pytest

from benchmark import gen
from benchmark.generators import ont, operons
from benchmark.reference import holes as ref_holes
from usearch12_tpu_torch import cli
from usearch12_tpu_torch.engine import batch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
# a read's first two candidates are accepted (they pass 50%), so that each
# pair's path is written, in two rounds of holes
OPTS = ["-id", "0.5", "-strand", "plus", "-maxaccepts", "2",
        "-maxrejects", "1", "-band", "16", "-quiet"]


def operon_set(seed: int, tmp_path, n_reads: int = 8):
    """(db FASTA, query FASTA, reference dict) of a small rrn set."""
    with open(os.path.join(BENCH, "configs", "rrn_operon.json")) as f:
        spec = json.load(f)["reference"]
    with open(os.path.join(BENCH, "traffic", "rrn_novel.json")) as f:
        qspec = json.load(f)["query"]
    spec.update(genera=3, species=2, copies=2)
    ref = operons.reference(spec, gen.rng_for(seed, 1))
    seqs, _ = ont.queries(qspec, ref, n_reads, gen.rng_for(seed, 2))
    db, q = str(tmp_path / "db.fa"), str(tmp_path / "q.fa")
    gen.write_fasta(db, ref["labels"], ref["seqs"])
    gen.write_fasta(q, [f"o{i}" for i in range(n_reads)], seqs)
    return db, q, ref


def _run(db, q, out, extra, monkeypatch, tmp_path):
    """blast6 bytes, [(job, target, path)] of every accepted pair, the
    holes [(a, b, cls, path)] and the USEARCH_DEVICE_STATS record."""
    pairs, seen = [], []
    orig_holes = batch.BatchEngine._align_holes
    orig_finish = batch.BatchEngine._finish_round

    def align_holes(self, sc, jbuf, n_hole):
        paths, off = orig_holes(self, sc, jbuf, n_hole)
        for k in range(n_hole):
            a0, b0 = int(sc.hole_aoff[k]), int(sc.hole_boff[k])
            seen.append((jbuf[a0:a0 + int(sc.hole_alen[k])].copy(),
                         self._db_concat[b0:b0 + int(sc.hole_blen[k])].copy(),
                         int(sc.hole_cls[k]),
                         paths[off[k]:off[k + 1]].tobytes()))
        return paths, off

    def finish_round(self, *args):
        res = orig_finish(self, *args)
        hj, ht, hp, hpo = res[:4]
        pairs.extend((int(hj[k]), int(ht[k]), hp[hpo[k]:hpo[k + 1]].tobytes())
                     for k in range(len(hj)))
        return res
    monkeypatch.setattr(batch.BatchEngine, "_align_holes", align_holes)
    monkeypatch.setattr(batch.BatchEngine, "_finish_round", finish_round)
    stats = tmp_path / f"{out}.stats"
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    b6 = tmp_path / out
    assert cli.main(["-usearch_global", q, "-db", db, "-blast6out", str(b6)]
                    + OPTS + extra, device="cpu") == 0
    monkeypatch.undo()
    return (b6.read_bytes(), sorted(pairs), seen,
            json.loads(stats.read_text().splitlines()[-1]))


@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 33 + 5])
def test_card_holes_equal_the_reference_and_the_host(seed, tmp_path,
                                                     monkeypatch):
    db, q, _ = operon_set(seed, tmp_path)
    b6_card, pairs_card, hs, ds = _run(db, q, "card.b6",
                                       ["-dev_batch_cells", "0"],
                                       monkeypatch, tmp_path)
    b6_host, pairs_host, hs_host, ds_host = _run(
        db, q, "host.b6", ["-no_engine_device"], monkeypatch, tmp_path)
    # every hole went to the card's kernels, and each was aligned once
    assert ds["dispatches"] > 0 and ds["host_cells"] == 0
    assert ds["holedp_pairs"] == len(hs) > 100
    assert ds["holedp_launches"] >= 2 * ds["dispatches"]
    # an align call a terminal class a dispatch: its geometry, then a
    # packing and a collection a piece of two launches
    assert ds["holedp_collect_n"] == ds["holedp_launches"] // 2
    assert ds["holedp_pack_n"] - ds["holedp_collect_n"] >= ds["dispatches"]
    assert ds_host["dispatches"] == 0 and "holedp_pairs" not in ds_host
    # the ITS's holes are hundreds of letters long
    assert max(len(a) for a, _, _, _ in hs) > 250
    scores, paths = ref_holes.align([(a, b, c) for a, b, c, _ in hs],
                                    {"match": 1.0, "mismatch": -2.0,
                                     "open": -10.0, "ext": -1.0,
                                     "term_open": -0.5, "term_ext": -0.5},
                                    16, workers=1)
    assert [p for _, _, _, p in hs] == paths
    # the card's rounds chain candidates ahead (depth 2, 4, 8), the host's
    # one at a time
    assert 0 < len(hs_host) <= len(hs)
    assert b6_card == b6_host and len(b6_card.splitlines()) == 2 * 8
    assert pairs_card == pairs_host


def test_gate_in_the_cells_regime(tmp_path, monkeypatch):
    """The dispatch gate of an engine that holds a cold card (a LocalCard:
    its first dispatch pays warm_tax, spread over 2 dispatches a window)
    with DevicePerfModel("cuda")'s cold constants, at the sizes of the
    rrn_operon cell: a round of 2.4 M gated cells (64 reads, one candidate
    each) stays on the host, the tax costing more than it saves; once the
    host's rate on such holes is learned (about 4e7 gated cells a second:
    an ITS hole's band is wider than its gated cells count), a round of 8
    candidates a read, the depth an engine with a card reaches, takes the
    card, tax included; then, warm, rounds of 2.4 M cells take it too."""
    monkeypatch.setattr(batch.DevicePerfModel, "CACHE",
                        str(tmp_path / "perf.json"))
    m = batch.DevicePerfModel("cuda")
    assert not m.warm and m.warm_tax == batch.COLD_WARM_TAX
    # a round's cells, its letters up and its paths' codes down, as
    # BatchEngine._align_holes counts them
    small = (2_400_000, 2 * 150_000, 150_000 // 4 + 4 * 9_000)
    big = tuple(8 * x for x in small)
    assert not m.device_wins(*small, 2) and not m.should_probe(small[0])
    for _ in range(12):
        m.observe_host(small[0], 0.06)
    assert 4e7 <= m.host_rate < 6e7
    assert not m.device_wins(*small, 2)
    assert m.device_wins(*big, 2)
    m.observe_dev(*big, m.t_dev(*big) + batch.COLD_WARM_TAX)
    assert m.warm and m.device_wins(*small, 2)


@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 33 + 5])
def test_a_longer_query_after_a_short_one_is_chained_alone(seed, tmp_path):
    """The HSP finder's query dictionary is cleared through the previous
    query's touched words before a query 512 or more letters longer
    replaces that list: searched after a short query, the long reads give
    the rows they give searched first (the clear once ran after the list
    was freed, and wrote through it: a crash, or stale words)."""
    db, q, ref = operon_set(seed, tmp_path)
    reads = open(q).read().split()
    short = ">short\n" + reads[1][:900] + "\n"
    longs = "".join(f"{reads[k]}\n{reads[k + 1]}\n"
                    for k in range(0, len(reads), 2))
    rows = []
    for name, text in (("after", short + longs), ("first", longs + short)):
        path = tmp_path / f"{name}.fa"
        path.write_text(text)
        out = tmp_path / f"{name}.b6"
        assert cli.main(["-usearch_global", str(path), "-db", db,
                         "-blast6out", str(out), "-no_engine_device"]
                        + OPTS, device="cpu") == 0
        rows.append(sorted(out.read_text().splitlines()))
    assert rows[0] == rows[1] and len(rows[0]) == 2 * 9
