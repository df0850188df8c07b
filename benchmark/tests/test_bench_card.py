"""The command as a check of the benchmark runs it: without a card it exits
2 and prints no result; in a directory that holds only BENCHMARK.json and
the benchmark it fails; on the card each cell runs and comes out correct
(marked cuda: those skip here)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(cwd, cell, seconds=3, trace=0, timeout=900):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=cwd, capture_output=True, text=True,
        timeout=timeout)


def _last_json(stdout):
    lines = stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None


def test_without_the_port_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, "gg99_v4.reads", timeout=300)
    assert r.returncode != 0
    assert _last_json(r.stdout) is None
    assert "usearch12_tpu_torch" in r.stderr


def test_without_a_card_it_exits_2():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(ROOT, "gg99_v4.reads", timeout=300)
    assert r.returncode == 2
    assert _last_json(r.stdout) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gg99_v4.reads", "gg99_v4.novel"])
def test_cell_is_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _run(ROOT, cell, trace=1)
    assert r.returncode == 0, r.stderr[-3000:]
    line = _last_json(r.stdout)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
