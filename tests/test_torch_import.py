"""usearch12_tpu_torch stands alone: it imports neither jax (the machine
with the card has none) nor the JAX package usearch12_tpu, whose host
layers it keeps its own copy of.  Its commands run in processes where
both cannot be imported, and write the JAX package's bytes."""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

import usearch12_tpu.cli as jax_cli
import usearch12_tpu_torch
from tests.test_sintax_device import _gen
from tests.test_torch_slice import gen_contigs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "usearch12_tpu_torch")
BLOCKED = ["jax", "usearch12_tpu"]


def _run_blocked(cwd, blocked, commands, **kw):
    """Run the port's CLI on each command line in a process of its own,
    in `cwd`, where the modules `blocked` cannot be imported."""
    code = ("import sys\n"
            f"for m in {blocked!r}: sys.modules[m] = None\n"
            "from usearch12_tpu_torch.cli import main\n"
            f"for args in {commands!r}:\n"
            f"    assert main(args + ['-quiet'], **{kw!r}) == 0, args\n"
            "bad = [m for m, v in sys.modules.items() if v is not None "
            "and (m in ('jax', 'usearch12_tpu') "
            "or m.startswith(('jax.', 'usearch12_tpu.')))]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _fastq_pairs(d):
    rng = np.random.default_rng(4)
    comp = str.maketrans("ACGT", "TGCA")
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for k in range(20):
            tpl = "".join("ACGT"[i] for i in rng.integers(0, 4, 200))
            a, b = tpl[:130], tpl[-120:].translate(comp)[::-1]
            f1.write(f"@p{k} 1:N:0\n{a}\n+\n{'I' * 130}\n")
            f2.write(f"@p{k} 2:N:0\n{b}\n+\n{'I' * 120}\n")


# (inputs, port command lines, JAX command lines, output files compared;
# "alnout" is compared without its first line, which quotes the argv)
CASES = {
    "usearch_global_engine": (
        "contigs",
        [["-usearch_global", "q.fa", "-db", "t.fa", "-id", "0.5", "-strand",
          "plus", "-band", "120", "-maxaccepts", "64", "-maxrejects", "64",
          "-dev_batch_cells", "1", "-blast6out", "g.b6", "-alnout",
          "g.aln"]],
        [["-usearch_global", "q.fa", "-db", "t.fa", "-id", "0.5", "-strand",
          "plus", "-band", "120", "-maxaccepts", "64", "-maxrejects", "64",
          "-no_engine_device", "-blast6out", "g.b6", "-alnout", "g.aln"]],
        ["g.b6", "g.aln"]),
    "sintax_device": (
        "sintax",
        [["-sintax", "q.fa", "-db", "db.fa", "-strand", "both",
          "-sintax_device", "-tabbedout", "tax.txt"]],
        [["-sintax", "q.fa", "-db", "db.fa", "-strand", "both",
          "-tabbedout", "tax.txt"]],
        ["tax.txt"]),
    "mesh": (
        "sintax",
        [["-usearch_global", "q.fa", "-db", "db.fa", "-id", "0.9",
          "-strand", "both", "-mesh", "2x4", "-blast6out", "m.b6"],
         ["-cluster_mt", "q.fa", "-id", "0.9", "-mesh", "1x2", "-uc", "mt.uc",
          "-centroids", "mt.fa"]],
        [["-usearch_global", "q.fa", "-db", "db.fa", "-id", "0.9",
          "-strand", "both", "-blast6out", "m.b6"],
         ["-cluster_mt", "q.fa", "-id", "0.9", "-uc", "mt.uc", "-centroids",
          "mt.fa"]],
        ["m.b6", "mt.uc", "mt.fa"]),
    "host_commands": (
        "fastq",
        [["-cluster_fast", "db.fa", "-id", "0.9", "-centroids", "c.fa",
          "-uc", "c.uc"],
         ["-fastx_uniques", "db.fa", "-fastaout", "u.fa", "-sizeout"],
         ["-fastq_mergepairs", "r1.fq", "-reverse", "r2.fq", "-fastqout",
          "m.fq"]],
        None,
        ["c.fa", "c.uc", "u.fa", "m.fq"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_commands_run_with_jax_package_blocked(tmp_path, case):
    """usearch_global on the engine path (its kernels' plain versions on
    the CPU), sintax on the card's path, the -mesh paths, and three host
    commands, in a process where neither jax nor usearch12_tpu can be
    imported; the outputs equal the JAX package's on the same inputs."""
    inputs, port_cmds, jax_cmds, outs = CASES[case]
    dirs = {k: tmp_path / k for k in ("port", "jax")}
    for d in dirs.values():
        d.mkdir()
        if inputs == "contigs":
            gen_contigs(str(d / "q.fa"), str(d / "t.fa"), n=3)
        else:
            _gen(d, n_db=40, n_q=12)
            _fastq_pairs(d)
    _run_blocked(dirs["port"], BLOCKED, port_cmds, device="cpu")
    cwd = os.getcwd()
    try:
        os.chdir(dirs["jax"])
        for args in jax_cmds or port_cmds:
            assert jax_cli.main(args + ["-quiet"]) == 0
    finally:
        os.chdir(cwd)
    for name in outs:
        got, want = ((dirs[k] / name).read_bytes() for k in ("port", "jax"))
        if name.endswith(".aln"):
            got, want = (x.split(b"\n", 1)[1] for x in (got, want))
        assert got == want, name
        assert got, name


def test_every_module_imports_with_jax_package_blocked():
    mods = [m.name for m in pkgutil.walk_packages(
        usearch12_tpu_torch.__path__, "usearch12_tpu_torch.")]
    assert len(mods) >= 60
    assert {"usearch12_tpu_torch.entry",
            "usearch12_tpu_torch.parallel.search_step"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_runs_with_jax_package_blocked():
    """`python -m usearch12_tpu_torch.entry 8 --device cpu` (the search
    step, then the dry run of every mesh path) in a process where jax and
    usearch12_tpu cannot be imported."""
    code = ("import runpy, sys\n"
            f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
            "sys.argv = ['entry', '8', '--device', 'cpu']\n"
            "runpy.run_module('usearch12_tpu_torch.entry', "
            "run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "entry OK" in r.stdout and "dryrun_multichip OK" in r.stdout


def test_host_commands_import_no_torch(tmp_path):
    """Commands that do not run on the card (here sintax below the auto
    gate, and two host commands) start without importing torch."""
    _gen(tmp_path, n_db=12, n_q=4)
    _run_blocked(tmp_path, BLOCKED + ["torch"], [
        ["-sintax", "q.fa", "-db", "db.fa", "-strand", "both",
         "-tabbedout", "tax.txt"],
        ["-fastx_uniques", "db.fa", "-fastaout", "u.fa"],
        ["-cluster_mt", "db.fa", "-id", "0.9", "-centroids", "c.fa"]])
    assert (tmp_path / "tax.txt").read_text().count("\n") == 4
    assert (tmp_path / "u.fa").stat().st_size > 0


# an import of jax, or of usearch12_tpu (not usearch12_tpu_torch), in any
# form: import statements, importlib, and `python -m` module names
PATTERNS = {
    "jax": re.compile(r"^\s*(import|from)\s+jax\b|import_module\(\s*['\"]jax",
                      re.M),
    "usearch12_tpu": re.compile(
        r"^\s*(import|from)\s+usearch12_tpu(?!\w)|\busearch12_tpu\.\w|"
        r"import_module\(\s*['\"]usearch12_tpu(?!\w)", re.M),
}


@pytest.mark.parametrize("name", list(PATTERNS))
def test_no_import_in_sources(name):
    """No source of the port, and no line of chip_smoke.py, imports jax or
    the JAX package or runs `-m usearch12_tpu.*`."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 60
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as f:
            m = PATTERNS[name].search(f.read())
        assert m is None, (path, m and m.group(0))
    for bad in ("import usearch12_tpu.cli", "from usearch12_tpu import x",
                "  from usearch12_tpu.config import options",
                '["-m", "usearch12_tpu.cli"]',
                'importlib.import_module("usearch12_tpu")'):
        assert PATTERNS["usearch12_tpu"].search(bad), bad
    assert not PATTERNS["usearch12_tpu"].search(
        "from usearch12_tpu_torch.cli import main\n"
        "'usearch12_tpu/ops/wavefront_nw.py:544'\n"
        'f_log.write(" ".join(["usearch12_tpu"] + argv))')


# the layers below the command layer (commands.py, cli.py)
LOWER = ("amplicon", "parallel", "engine", "ops", "index", "io", "search",
         "align", "cluster", "fastq", "out")
# the route to the card is card.py's decision (and the server's, behind it)
ROUTE_NAMES = re.compile(r"\b(is_server|server_warm|ServerDevice|"
                         r"CSRServerRanker|ServerBootEngine|"
                         r"ServerClassAligner)\b")


def _imported(path):
    """The absolute names of the modules a source file of the port
    imports (`from P import n` counts P and P.n)."""
    pkg = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".").rsplit(
        ".", 1)[0]
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def _sources(*dirs):
    return [os.path.join(d, f) for top in dirs
            for d, _, fs in os.walk(os.path.join(PKG, top))
            for f in fs if f.endswith(".py")]


@pytest.mark.parametrize("rule", ["lower_layers_import_no_commands",
                                  "one_module_routes_the_card"])
def test_card_routing_design(rule):
    """The arrows between the port's layers point down: nothing under the
    lower layers imports commands or cli.  And only card.py (with the
    server behind it) knows which route the card's work takes: no other
    module names the server's route."""
    if rule == "lower_layers_import_no_commands":
        files = _sources(*LOWER)
        assert len(files) >= 50
        up = {"usearch12_tpu_torch.commands", "usearch12_tpu_torch.cli"}
        for path in files:
            assert not up & set(_imported(path)), path
        probe = os.path.join(PKG, "amplicon", "sintax.py")
        assert "usearch12_tpu_torch.index.udbfile.load_db" in set(
            _imported(probe))
    else:
        files = _sources("")
        assert len(files) >= 60
        for path in files:
            if os.path.basename(path) in ("card.py", "device_server.py"):
                continue
            with open(path) as f:
                m = ROUTE_NAMES.search(f.read())
            assert m is None, (path, m and m.group(0))
        assert ROUTE_NAMES.search("if getattr(dev, 'server_warm', False):")

