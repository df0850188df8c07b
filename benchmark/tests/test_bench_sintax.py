"""The sintax cell on the CPU at a tiny size (the kernels' plain versions):
the plain reference equals the port, rows and each classified strand's
boots, at -strand plus and both; the control fails winners_wrong; planted
faults each fail a check; the generators repeat per seed; and
sintax_boot_roofline's bytes against a hand count."""

import copy

import numpy as np
import pytest
import torch

from benchmark import gen, harness
from benchmark.reference import sintax as ref_sintax

CELL = "sintax_rdp18.classify"
SEED = 2 ** 31 + 29
CPU = torch.device("cpu")


def tiny_spec(strand: str = "both") -> dict:
    """The cell with 240 targets in 20 genera, 10 boots, requests of 40
    reads, every read of a judged request sampled."""
    spec = harness.cell_spec(CELL)
    cfg, tr = spec["config"], spec["traffic"]
    cfg["reference"].update(targets=240, ranks={"d": 2, "p": 3, "c": 4,
                                                "o": 5, "f": 6, "g": 20})
    cfg["options"].update(boots=10, strand=strand)
    tr.update(per_request=40, pool=3, warmup=1)
    tr["check"].update(within=2, row_queries=80)
    return spec


def _checks(out):
    return {k: v["value"] for k, v in out["result"]["checks"].items()}


@pytest.mark.parametrize("strand", ["plus", "both"])
def test_reference_equals_the_port(strand):
    out = harness.run_cell(tiny_spec(strand), SEED, 0.5, False, device="cpu")
    assert _checks(out) == {"rows_wrong": 0, "winners_wrong": 0}
    assert out["result"]["correct"] is True


def test_control_fails_winners_wrong():
    out = harness.run_cell(tiny_spec(), SEED, 0.5, False, device="cpu",
                           control=True)
    assert out["result"]["correct"] is False
    assert _checks(out)["winners_wrong"] > 0


@pytest.fixture(scope="module")
def judged(tmp_path_factory):
    """(spec, data, a judged record of request 0) from the port."""
    spec = tiny_spec()
    drv = gen.plugin(spec["bench_dir"], "commands", "sintax")
    data = drv.make_data(spec, SEED)
    sess = drv.Session(spec, data, SEED, str(tmp_path_factory.mktemp("s")),
                       CPU, False, lambda _name: None)
    rec = {"req": 0, "keep": True}
    sess.request(0, rec)
    return spec, data, rec, drv


def _judge(judged, rec):
    spec, data, _, drv = judged
    return dict((n, v) for n, v, _ in drv.judge(spec, data, [rec], SEED,
                                                CPU))


def test_planted_faults_fail_a_check(judged):
    rec = judged[2]
    assert _judge(judged, rec) == {"rows_wrong": 0, "winners_wrong": 0}
    # boots tie: the tie-break shows in the winners
    assert any(len(set(w.tolist())) > 1 for q in rec["boots"] for x in q
               if x is not None for w in [x[0]])
    bad = copy.deepcopy(rec)                       # an altered winner
    w = bad["boots"][5][0][0]
    w[3] = (w[3] + 1) % 240
    assert _judge(judged, bad)["winners_wrong"] == 1
    bad = copy.deepcopy(rec)                       # an altered row
    lines = bad["rows"].splitlines(True)
    lines[7] = lines[7].replace("(", "(0", 1)
    bad["rows"] = "".join(lines)
    assert _judge(judged, bad)["rows_wrong"] == 1
    bad = copy.deepcopy(rec)                       # a query left out
    bad["rows"] = "".join(bad["rows"].splitlines(True)[:-1])
    bad["boots"] = bad["boots"][:-1]
    got = _judge(judged, bad)
    assert got["rows_wrong"] == 1 and got["winners_wrong"] == 2


def test_generators_repeat_per_seed():
    spec = tiny_spec()
    a, b, c = (gen.make_data(spec["bench_dir"], spec["config"],
                             spec["traffic"], s) for s in (SEED, SEED, 7))
    assert a[0]["labels"] == b[0]["labels"]
    assert all(np.array_equal(x, y) for x, y in zip(a[0]["seqs"],
                                                    b[0]["seqs"]))
    assert all(np.array_equal(x["seqs"], y["seqs"]) for x, y in zip(a[1],
                                                                    b[1]))
    assert not np.array_equal(a[1][0]["seqs"], c[1][0]["seqs"])
    ref = a[0]
    lengths = [len(s) for s in ref["seqs"]]
    assert 1200 <= min(lengths) and max(lengths) <= 1600
    # every read is its parent's V4 window with 0-12 substitutions
    for req in a[1]:
        for s, t in zip(req["seqs"], req["parents"]):
            at = ref["v4"][t]
            assert (s != ref["seqs"][t][at:at + 253]).sum() <= 12


def test_boot_bytes_against_a_hand_count():
    sizes = np.zeros(4 ** 8, np.int64)
    sizes[[1, 2, 3]] = [2, 10, 0]
    strands = [np.array([1, 2]), np.array([2, 3])]
    # 100 targets: a bit a target is 13 bytes; word 1's list 8 bytes, word
    # 2's 40 > 13, word 3's none; 2 strands x 10 boots x 8 bytes written
    assert ref_sintax.boot_bytes(sizes, 100, strands, 10) == 8 + 13 + 160
    roof = gen.plugin(harness.BENCH, "metrics", "sintax_boot_roofline")
    run = {"trace": {"device_ops": [
        ["void sintax_boot_count_kernel<false>(unsigned char const*)", 2e-6],
        ["sintax_pick_hist_kernel", 1e-6], ["Memcpy HtoD", 5e-6]]},
        "requests": [{"boot_bytes": 3350}, {"boot_bytes": 6700}]}
    assert roof.read(run) == pytest.approx(100 * 10050 / 3.35e12 / 3e-6)
    run["trace"]["device_ops"] = [["Memcpy HtoD", 5e-6]]
    assert roof.read(run) is None
    assert roof.read({"trace": None, "requests": []}) is None


def test_boot_bytes_counted_after_the_window(tmp_path):
    """A traced session builds no reference in its set-up; notes(), the
    harness's first call after the window, puts each request's boot bytes
    into its record, from the one reference that judge() then uses."""
    spec = tiny_spec()
    drv = gen.plugin(spec["bench_dir"], "commands", "sintax")
    data = drv.make_data(spec, SEED)
    marks = []
    sess = drv.Session(spec, data, SEED, str(tmp_path), CPU, True,
                       marks.append)
    assert drv._built[0] is not data[0]
    assert marks == ["queries written", "reference written", "db ready"]
    recs = [{"req": r, "keep": r == 1} for r in (0, 1, 0)]
    for rec in recs:
        sess.request(rec["req"], rec)
    assert all("boot_bytes" not in rec for rec in recs)
    assert any("boot bytes counted" in line for line in sess.notes())
    rs = drv.reference(spec["config"], data[0], CPU)
    assert drv._built[0] is data[0]
    for rec in recs:
        strands = [u for s in data[1][rec["req"]]["seqs"]
                   for u in rs.strands(s) if u is not None]
        assert rec["boot_bytes"] == ref_sintax.boot_bytes(
            rs.sizes, rs.T, strands, rs.B) > 0
    assert dict((n, v) for n, v, _ in drv.judge(
        spec, data, recs[1:2], SEED, CPU)) == {"rows_wrong": 0,
                                               "winners_wrong": 0}
    assert drv.reference(spec["config"], data[0], CPU) is rs
