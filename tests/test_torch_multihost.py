"""usearch12_tpu_torch's multihost_search (parallel/multihost.py) in two
CPU processes joined over gloo (torch.distributed), each searching its
stripe of the queries on a (1, 4) mesh of CPU entries: the spliced blast6
equals a single-process run of the port and of the JAX package's host
engine.  Tolerance: bytes."""

import os
import socket
import subprocess
import sys

import pytest

import usearch12_tpu.cli as jax_cli
import usearch12_tpu_torch.cli as port_cli
from tests.genseqs import make_amplicons, write_fasta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one process of the group: jax and usearch12_tpu cannot be imported
WORKER = """
import sys
for m in ("jax", "usearch12_tpu"):
    sys.modules[m] = None
import torch.distributed as dist
from usearch12_tpu_torch.cli import parse_argv
from usearch12_tpu_torch.parallel.multihost import (init_multihost,
                                                    multihost_search)
rank, port, q_fa, db_fa, out = sys.argv[1:6]
init_multihost(f"tcp://127.0.0.1:{port}", 2, int(rank))
parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
            "-strand", "plus", "-quiet"])
stats = multihost_search(q_fa, db_fa, out, topk=32, window=16,
                         device="cpu", db_per_host=4)
assert stats["queries"] == 45 and stats["windows"] == 3, stats
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mh_data(tmp_path_factory):
    """tests/test_multihost.py's fixture: 30 templates as the DB, their 90
    reads as the queries."""
    d = tmp_path_factory.mktemp("mh")
    recs = make_amplicons(n_templates=30, reads_per_template=3, length=180,
                          seed=23)
    db_fa, q_fa = str(d / "db.fa"), str(d / "q.fa")
    write_fasta(db_fa, [r for r in recs if r[0].startswith("tpl")])
    write_fasta(q_fa, [r for r in recs if not r[0].startswith("tpl")])
    return db_fa, q_fa, d


def test_two_process_search_equals_one(mh_data):
    db_fa, q_fa, d = mh_data
    out = str(d / "mh.b6")
    port = str(_free_port())
    workers = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), port, q_fa, db_fa, out],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        errs = [w.communicate(timeout=120)[1] for w in workers]
    finally:
        for w in workers:
            w.kill()
    for w, e in zip(workers, errs):
        assert w.returncode == 0, e.decode()[-2000:]
    outs = {}
    for name, main, kw in (("port", port_cli.main, {"device": "cpu"}),
                           ("jax", jax_cli.main, {})):
        path = str(d / f"{name}.b6")
        assert main(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                     "-strand", "plus", "-quiet", "-no_engine_device",
                     "-blast6out", path], **kw) == 0
        outs[name] = open(path, "rb").read()
    got = open(out, "rb").read()
    assert got == outs["port"] == outs["jax"]
    assert got.count(b"\n") >= 90
