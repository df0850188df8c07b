"""usearch12_tpu_torch imports no jax: the machine with the card has none."""

import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "usearch12_tpu_torch")


def test_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import usearch12_tpu_torch, usearch12_tpu_torch.cli, "
            "usearch12_tpu_torch.commands, usearch12_tpu_torch.engine.batch, "
            "usearch12_tpu_torch.ops.banded_nw, "
            "usearch12_tpu_torch.ops.sintax_boot, "
            "usearch12_tpu_torch.amplicon.sintax, "
            "usearch12_tpu_torch.amplicon.sintax_device\n"
            "bad = [m for m in sys.modules if m.startswith(("
            "'usearch12_tpu.ops', 'usearch12_tpu.parallel', "
            "'usearch12_tpu.device_server'))]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _run_blocked(tmp_path, blocked, commands, **kw):
    """Write a 12-sequence taxonomy DB and run the port's CLI on each
    command line ("DB" stands for its path) in a process where the
    modules `blocked` cannot be imported."""
    rng = np.random.default_rng(3)
    db = tmp_path / "db.fa"
    db.write_text("".join(
        f">r{i};tax=d:D{i % 2},g:G{i % 4};\n"
        + "".join("ACGT"[k] for k in rng.integers(0, 4, 200)) + "\n"
        for i in range(12)))
    code = ("import sys\n"
            f"for m in {blocked!r}: sys.modules[m] = None\n"
            "from usearch12_tpu_torch.cli import main\n"
            f"for args in {commands!r}:\n"
            f"    assert main(args + ['-quiet'], **{kw!r}) == 0, args\n")
    code = code.replace("DB", str(db))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "tax.txt").read_text().count("\n") == 12
    assert (tmp_path / "u.fa").stat().st_size > 0


def test_sintax_and_host_commands_run_with_jax_blocked(tmp_path):
    """-sintax on the card's path (the plain versions on the CPU) and two
    delegated host commands, in a process where jax cannot be imported."""
    _run_blocked(tmp_path, ["jax"], [
        ["-sintax", "DB", "-db", "DB", "-strand", "both", "-sintax_device",
         "-tabbedout", "tax.txt"],
        ["-fastx_uniques", "DB", "-fastaout", "u.fa"],
        ["-cluster_fast", "DB", "-id", "0.9", "-centroids", "c.fa"]],
        device="cpu")


def test_host_commands_import_no_torch(tmp_path):
    """Commands that do not run on the card (here sintax below the auto
    gate, and two delegated commands) start without importing torch."""
    _run_blocked(tmp_path, ["jax", "torch"], [
        ["-sintax", "DB", "-db", "DB", "-strand", "both", "-tabbedout",
         "tax.txt"],
        ["-fastx_uniques", "DB", "-fastaout", "u.fa"],
        ["-cluster_mt", "DB", "-id", "0.9", "-centroids", "c.fa"]])


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 8
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as f:
            assert not pat.search(f.read()), path
