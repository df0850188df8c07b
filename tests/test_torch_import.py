"""usearch12_tpu_torch imports no jax: the machine with the card has none."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "usearch12_tpu_torch")


def test_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import usearch12_tpu_torch, usearch12_tpu_torch.cli, "
            "usearch12_tpu_torch.commands, usearch12_tpu_torch.engine.batch, "
            "usearch12_tpu_torch.ops.banded_nw\n"
            "bad = [m for m in sys.modules if m.startswith(("
            "'usearch12_tpu.ops', 'usearch12_tpu.parallel', "
            "'usearch12_tpu.device_server'))]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 8
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as f:
            assert not pat.search(f.read()), path
