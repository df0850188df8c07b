"""The check against faults: a run of each cell, with the timed path
broken underneath, comes out not correct; so does each cell's control.

Faults (those a cell can have; no cell trains and none spans cards, so a
state left unchanged and a lost exchange between chips do not apply):
half of each request's queries left out, a ranked list altered where it
is produced, a blast6 answer altered where it is written."""

import io

import numpy as np
import pytest

from conftest import CELLS


def _half_batch(monkeypatch):
    from usearch12_tpu_torch.engine.batch import BatchEngine
    orig = BatchEngine.run_file

    def run_file(self, path, *args, **kw):
        n = open(path).read().count(">")
        return orig(self, path, *args, records=(0, n // 2), **kw)
    monkeypatch.setattr(BatchEngine, "run_file", run_file)


def _rank_altered(monkeypatch):
    from usearch12_tpu_torch.ops import csr_rank
    orig = csr_rank.make_engine_override

    def make(ranker, eng):
        over = orig(ranker, eng)

        def override(jbuf, j_off):
            cand, cnts, out_n = over(jbuf, j_off)
            cand[0, :2] = cand[0, 1::-1].copy()
            return cand, cnts, out_n
        return override
    monkeypatch.setattr(csr_rank, "make_engine_override", make)


def _emit_altered(monkeypatch):
    from usearch12_tpu_torch.engine.emit import Blast6Emitter
    orig = Blast6Emitter.emit_packed

    def emit_packed(self, *args):
        real, self.f = self.f, io.StringIO()
        orig(self, *args)
        lines = self.f.getvalue().split("\n")
        f = lines[0].split("\t")
        f[2] = f"{float(f[2]) - 0.1:.1f}"
        lines[0] = "\t".join(f)
        self.f = real
        real.write("\n".join(lines))
    monkeypatch.setattr(Blast6Emitter, "emit_packed", emit_packed)


FAULTS = {"half_batch": _half_batch, "rank_altered": _rank_altered,
          "emit_altered": _emit_altered}
CASES = [("gg99_v4.reads", "half_batch"), ("gg99_v4.reads", "rank_altered"),
         ("gg99_v4.reads", "emit_altered"), ("gg99_v4.novel", "half_batch"),
         ("gg99_v4.novel", "rank_altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(run_tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = run_tiny(cell)["result"]
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_tiny, cell):
    res = run_tiny(cell, control=True)["result"]
    assert res["correct"] is False
    assert res["checks"]["rank_lists_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(run_tiny, cell):
    res = run_tiny(cell)["result"]
    assert res["correct"] is True, res["checks"]
    assert np.isfinite([c["value"] for c in res["checks"].values()]).all()
