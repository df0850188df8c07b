"""The card path's SINTAX tally and strand vote on the CPU: the C runtime's
sintax_tally_window_c (through SintaxTorchClassifier.tally) against the
Python loop it keeps for a missing library, tuple for tuple, on built
winners and tops; and on a real window of SintaxRun's boots, with only the
native call counted."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import usearch12_tpu_torch.native as native
from tests.test_torch_sintax_resident import _argv, _data
from usearch12_tpu_torch.amplicon.sintax import WINDOW, SintaxRun
from usearch12_tpu_torch.amplicon.sintax_device import SintaxTorchClassifier
from usearch12_tpu_torch.cli import parse_argv
from usearch12_tpu_torch.io.fastx import read_fastx

CPU = torch.device("cpu")
K = 400                                 # taxa
_rng = np.random.default_rng(0)
# each taxon has a target; 600 more targets of random taxa
TAX = _rng.permutation(np.concatenate(
    [np.arange(K), _rng.integers(0, K, 600)])).astype(np.int32)
BY_TAX = [np.flatnonzero(TAX == k) for k in range(K)]

# name: (queries, boots, taxa a strand (None: 1 to boots), share of strands
# without a job (fwd, rev), both strands, top word counts: "random",
# "equal" on both strands, or "zero" now and then)
CASES = {
    "empty": (0, 100, None, (0, 0), True, "random"),
    "no_job": (7, 100, None, (1, 1), True, "random"),
    "fwd_without_job": (40, 100, None, (1, 0), True, "zero"),
    "rev_without_job": (40, 100, None, (0, 1), True, "zero"),
    "plus_only": (40, 100, None, (0.2, 1), False, "random"),
    "equal_twc": (40, 100, None, (0, 0), True, "equal"),
    "count_ties": (40, 100, 10, (0, 0), True, "random"),
    "count_ties_4": (40, 100, 4, (0, 0), True, "random"),
    "ntax_63": (20, 100, 63, (0, 0), True, "random"),
    "ntax_64": (20, 100, 64, (0, 0), True, "random"),
    "ntax_100": (20, 100, 100, (0, 0), True, "random"),
    "boots_1": (40, 1, None, (0.2, 0.2), True, "zero"),
    "boots_300": (20, 300, 290, (0.1, 0.1), True, "random"),
    "mixed": (WINDOW, 100, None, (0.1, 0.2), True, "zero"),
}


def _strand_winners(rng, B, ntax):
    """B winning targets of exactly ntax taxa, with counts spread evenly
    where ntax divides B (ties in every count), else at random."""
    taxa = rng.choice(K, ntax, replace=False)
    if B % ntax == 0:
        seq = np.repeat(taxa, B // ntax)
    else:
        seq = np.concatenate([taxa, rng.choice(taxa, B - ntax)])
    seq = rng.permutation(seq)
    return np.array([rng.choice(BY_TAX[t]) for t in seq], np.int32)


def _window(name):
    n_q, B, ntax, (p_f, p_r), both, tw = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 1)
    per_q, winners, tops = [], [], []
    for _ in range(n_q):
        ixs, top_q = [], None
        for p in (p_f, p_r):
            if rng.random() < p:
                ixs.append(None)
                continue
            ixs.append(len(winners))
            k = ntax or int(rng.integers(1, B + 1))
            winners.append(_strand_winners(rng, B, k))
            t = rng.integers(0, 40, B).astype(np.int32)
            if tw == "zero" and rng.random() < 0.2:
                t[:] = 0
            if tw == "equal":
                top_q = int(t.max()) if top_q is None else top_q
                t[0] = top_q
                t[1:] = np.minimum(t[1:], top_q)
            tops.append(t)
        per_q.append(ixs)
    winners = np.array(winners, np.int32).reshape(-1, B)
    tops = np.array(tops, np.int32).reshape(-1, B)
    return per_q, winners, tops, both, B


def _classifier(B):
    dev = SintaxTorchClassifier.__new__(SintaxTorchClassifier)
    dev.cls = SimpleNamespace(boots=B, _tax_id=TAX)
    dev.stats = {}
    return dev


@pytest.mark.parametrize("name", list(CASES))
def test_native_tally_equals_python_loop(name, monkeypatch):
    assert native.get_lib() is not None
    per_q, winners, tops, both, B = _window(name)
    dev = _classifier(B)
    got = dev.tally(per_q, winners, tops, both)
    assert dev.stats["sintax_tally_native"] == 1
    monkeypatch.setattr(native, "get_lib", lambda: None)
    want = dev.tally(per_q, winners, tops, both)
    assert dev.stats["sintax_tally_native"] == 1
    assert got == want and len(got) == len(per_q)
    ntax = [len(ids) for _, ids, _, _ in got]
    if name.startswith("ntax_") or name == "boots_300":
        assert CASES[name][2] in ntax
    if name.startswith("count_ties"):
        assert all(len(set(c)) == 1 for _, _, c, _ in got if c)
    if name == "equal_twc":
        assert {s for s, _, _, _ in got} == {"+"}
    if name in ("fwd_without_job", "mixed"):
        assert {s for s, _, _, _ in got} == {"+", "-"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _data(tmp_path_factory.mktemp("tally"), 13, n_q=300)


@pytest.mark.parametrize("both", [True, False])
def test_real_window_without_the_library_gives_the_same_tuples(
        files, both, monkeypatch):
    db, q1, _ = files
    parse_argv(_argv(db, "-sintax_device", "both" if both else "plus"))
    run = SintaxRun(CPU)
    dev = run.dev_cls
    seqs = [s for _, s, _ in read_fastx(q1)][:WINDOW]
    per_q, winners, tops = dev.boots(seqs, both)
    assert len(winners) > 100
    got = dev.tally(per_q, winners, tops, both)
    assert dev.stats["sintax_tally_native"] == 1
    monkeypatch.setattr(native, "get_lib", lambda: None)
    want = dev.tally(per_q, winners, tops, both)
    assert dev.stats["sintax_tally_native"] == 1
    assert got == want and len(got) == len(seqs)
    assert any(not ids for _, ids, _, _ in got)     # the 10-nt read
