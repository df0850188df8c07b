"""The rrn_operon configuration on the CPU: its generators' shapes, the
hole reference's counts, the check against planted faults (in the
judged records, and in the engine: a read skipped, half the candidates
dropped, a stop before -maxrejects, a pair accepted below -id) and the
control, and the new metrics' readers without the program's spans.

The cell runs through the harness at a CPU's size (3 genera of 2 species,
12 targets; 4 reads a request; -maxrejects 2, -dev_batch_cells 0 so that
every hole goes to the kernels' plain versions), the reference DP on one
process."""

import copy
import functools
import json
import os

import numpy as np
import pytest

from benchmark import gen
from benchmark.generators import ont, operons
from benchmark.reference import dp, holes
from usearch12_tpu_torch.engine import batch

CELL = "rrn_operon.novel"
CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                      "rrn_operon.json")


def _spec():
    from benchmark import harness
    spec = harness.cell_spec(CELL)
    cfg, tr = spec["config"], spec["traffic"]
    cfg["reference"].update(genera=3, species=2, copies=2)
    cfg["search"]["maxrejects"] = 2
    cfg["program_options"] = ["-dev_batch_cells", "0"]
    tr.update(per_request=4, pool=2, warmup=1)
    tr["check"].update(within=1)
    return spec


@pytest.fixture
def one_process(monkeypatch):
    monkeypatch.setattr(holes, "align",
                        functools.partial(holes.align, workers=1))


@pytest.fixture(scope="module")
def judged():
    """(spec, data, records, result) of one tiny run on the CPU."""
    from benchmark import harness
    spec = _spec()
    mod = gen.plugin(spec["bench_dir"], "commands",
                     spec["config"]["command"])
    seen = {}
    orig, align = mod.judge, holes.align

    def judge(spec, data, records, seed, device):
        seen.update(spec=spec, data=data, records=records)
        return orig(spec, data, records, seed, device)
    mod.judge = judge
    holes.align = functools.partial(align, workers=1)
    try:
        out = harness.run_cell(spec, 2 ** 31 + 11, 0.2, True, device="cpu")
    finally:
        mod.judge, holes.align = orig, align
    return seen["spec"], seen["data"], seen["records"], out["result"]


def test_reference_shapes_and_held_out_species():
    with open(CONFIG) as f:
        spec = json.load(f)["reference"]
    spec.update(genera=3, species=2, copies=2)
    ref = operons.reference(spec, gen.rng_for(2 ** 31 + 5, 1))
    again = operons.reference(spec, gen.rng_for(2 ** 31 + 5, 1))
    assert all(np.array_equal(a, b) for a, b in zip(ref["seqs"],
                                                    again["seqs"]))
    assert len(ref["seqs"]) == 12 and len(ref["held"]) == 6
    assert ref["labels"][:3] == ["rrn0_0_0", "rrn0_0_1", "rrn0_1_0"]
    lo, hi = spec["its"]
    for s in ref["seqs"] + ref["held"]:
        assert 1540 + lo + 2900 <= len(s) <= 1540 + hi + 2900
        assert set(np.unique(s).tolist()) <= set(b"ACGT")
    for s, at in zip(ref["held"], ref["held_23s"]):
        assert len(s) - at == 2900
    # no held-out operon is in the reference, and each held species's
    # 16S is 1.35-5.5% (plus copies' substitutions) from those of its
    # genus's other species, and further from other genera's
    for h, g in zip(ref["held"], ref["held_genus"]):
        assert not any(np.array_equal(h, s) for s in ref["seqs"])
        d = [float((h[:1540] != s[:1540]).mean()) for s in ref["seqs"]]
        same = [x for x, lab in zip(d, ref["labels"])
                if lab.startswith(f"rrn{g}_")]
        assert 0.011 < min(same) and max(same) < 0.06
        assert min(same) < min(x for x in d if x not in same)


def test_reads_are_amplicons_with_their_error_rate():
    rng = gen.rng_for(3)
    seq = gen.ACGT[rng.integers(0, 4, 3000)]
    assert np.array_equal(ont.with_errors(rng, seq, 0.0), seq)
    read = ont.with_errors(rng, seq, 0.07)
    _, (path,) = dp.align([(read, seq)], [dp.penalties(
        1.0, -2.0, -10.0, -1.0, -0.5, -0.5)], 64, traceback=True)
    ops = np.frombuffer(path, np.uint8)
    qa = np.cumsum(ops != ord("I")) - 1
    tb = np.cumsum(ops != ord("D")) - 1
    m = ops == ord("M")
    subs = int((read[qa[m]] != seq[tb[m]]).sum())
    ins, dels = int((ops == ord("D")).sum()), int((ops == ord("I")).sum())
    # the optimal alignment writes an insertion and a deletion a few
    # letters apart as mismatches (-2 each against two opens of -10), so
    # it counts more substitutions and fewer indels than were made
    assert 0.06 < (subs + ins + dels) / len(seq) < 0.11
    assert min(ins, dels) > 0.15 * (subs + ins + dels)
    with open(CONFIG) as f:
        spec = json.load(f)["reference"]
    spec.update(genera=2, species=1, copies=2)
    ref = operons.reference(spec, gen.rng_for(5, 1))
    q = {"from_16s": 7, "to_23s": 2241, "error": [0.05, 0.09]}
    seqs, parents = ont.queries(q, ref, 20, gen.rng_for(5, 2))
    for s, p in zip(seqs, parents):
        amp = len(ref["held"][p]) - 2900 - 7 + 2241
        # the 27F-2241R amplicons are 4.3-4.7 kb
        assert 4300 <= amp <= 4710
        assert abs(len(s) - amp) < 0.04 * amp


def test_band_cells_count_the_band():
    rng = np.random.default_rng(1)
    la = rng.integers(1, 120, 300)
    lb = np.maximum(1, la + rng.integers(-60, 61, 300))
    for r in (0, 3, 16):
        want = []
        for x, y in zip(la, lb):
            lo, hi = dp.band_range(int(x), int(y), r)
            i, j = np.meshgrid(np.arange(x), np.arange(y), indexing="ij")
            d = x - i + j
            want.append(int(((d >= lo) & (d <= hi)).sum()))
        assert holes.band_cells(la, lb, r).tolist() == want
    # a 4.5 kb pair in a band of 33: the traceback's 4 bits a cell at
    # 3.35 TB/s bound it, a little above its 9 operations a cell at 67
    # TFLOP/s
    cells = holes.band_cells([4500], [4500], 16)[0]
    t = holes.hole_bound([4500], [4500], 16)
    assert t == pytest.approx(holes.hole_bytes([4500], [4500], 16)[0]
                              / 3.35e12) and t > 9 * cells / 67e12


def test_sound_run_is_correct_and_reads_its_metrics(judged):
    _, _, records, res = judged
    assert res["correct"] is True, res["checks"]
    for name in ("holes_wrong", "holes_unjudged_on_card", "rank_lists_wrong",
                 "pairs_wrong", "accepts_wrong", "rows_vs_paths_wrong"):
        assert res["checks"][name]["value"] == 0, name
    # the judged reads chained their candidates: 3 a read (maxaccepts 1 +
    # maxrejects 2), whole paths spliced for them
    rec = next(r for r in records if r["keep"])
    assert len(rec["ranked"]) == 1
    assert sum(int(rp["used"].sum()) for rp in rec["replays"]) >= 4 * 2
    m = res["metrics"]
    # the CPU's trace has no kernels: no roofline
    assert {"holes_ms_per_query", "holedp_host_ms_per_query",
            "holedp_device_ms_per_query", "gate_device_cell_share"} <= set(m)
    assert "holedp_roofline" not in m
    assert m["gate_device_cell_share"]["value"] == 100.0
    assert sum(len(c["a"]) for r in records if r["keep"]
               for c in r["holes"]) > 50


@pytest.mark.parametrize("fault", ["altered", "dropped"])
def test_planted_hole_fault_counts_one(judged, fault, one_process):
    spec, data, records, _ = judged
    mod = gen.plugin(spec["bench_dir"], "commands",
                     spec["config"]["command"])
    recs = copy.deepcopy(records)
    call = next(c for r in recs if r["keep"] for c in r["holes"])
    if fault == "altered":
        a, b = call["a"][0], call["b"][0]
        call["paths"][0] = b"D" * len(a) + b"I" * len(b)
    else:
        # the hole aligned to nothing: no path came back for it
        call["paths"][0] = b""
    checks = {n: v for n, v, _ in mod.judge(spec, data, recs, 0, "cpu")}
    assert checks["holes_wrong"] == 1
    assert checks["rows_vs_paths_wrong"] == 0


def _rank_cut(cut):
    orig = batch.BatchEngine._rank_jobs

    def rank_jobs(self, jbuf, j_off, sc=None):
        cand, cnts, out_n = orig(self, jbuf, j_off, sc)
        return cand, cnts, cut(out_n.copy())
    return "_rank_jobs", rank_jobs


def _replay_with(**attrs):
    orig = batch.BatchEngine._finish_round

    def finish_round(self, *args):
        for k, v in attrs.items():
            setattr(self, k, v)
        return orig(self, *args)
    return "_finish_round", finish_round


def _skip_first(out_n):
    out_n[0] = 0
    return out_n


# a planted fault of the engine: (what it patches, the checks that must
# count it)
ENGINE_FAULTS = {
    "read_skipped": (lambda: _rank_cut(_skip_first),
                     ("rank_lists_wrong", "pairs_wrong")),
    "half_the_candidates": (lambda: _rank_cut(lambda n: n // 2),
                            ("rank_lists_wrong", "pairs_wrong")),
    "stops_early": (lambda: _replay_with(max_rejects=1), ("pairs_wrong",)),
    "accepts_below_id": (lambda: _replay_with(min_id=0.5),
                         ("accepts_wrong", "pairs_wrong")),
}


@pytest.mark.parametrize("fault", sorted(ENGINE_FAULTS))
def test_planted_engine_fault_is_not_correct(fault, one_process,
                                             monkeypatch):
    from benchmark import harness
    patch, counted = ENGINE_FAULTS[fault]
    monkeypatch.setattr(batch.BatchEngine, *patch())
    res = harness.run_cell(_spec(), 2 ** 31 + 11, 0.2, False,
                           device="cpu")["result"]
    assert res["correct"] is False
    checks = {n: c["value"] for n, c in res["checks"].items()}
    for name in counted:
        assert checks[name] > 0, (name, checks)
    assert checks["rows_vs_paths_wrong"] == 0
    if fault in ("stops_early", "accepts_below_id"):
        assert checks["rank_lists_wrong"] == 0


def test_control_is_not_correct(one_process):
    from benchmark import harness
    res = harness.run_cell(_spec(), 2 ** 31 + 12, 0.2, False, device="cpu",
                           control=True)["result"]
    assert res["correct"] is False
    assert res["checks"]["holes_wrong"]["value"] > 0


def test_readers_give_nothing_without_the_spans():
    from benchmark import harness
    spec = harness.cell_spec(CELL)
    run = {"counters": {"queries": 64, "dispatches": 0}, "trace": None,
           "requests": [], "config": spec["config"]}
    for m in spec["per_layer"]:
        assert gen.plugin(spec["bench_dir"], "metrics",
                          m["name"]).read(run) is None, m["name"]
    run["trace"] = {"device_ops": [["void csr_rank_big_kernel", 1.0]]}
    run["requests"] = [{"dev_holes": [(np.array([50]), np.array([60]))]}]
    assert gen.plugin(spec["bench_dir"], "metrics",
                      "holedp_roofline").read(run) is None
