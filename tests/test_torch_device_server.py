"""usearch12_tpu_torch's resident device server (device_server.py) on the
CPU: a server started with --device cpu (the kernels' plain versions) on
a short socket path under /tmp, its ops held bit for bit against the JAX
package on the same seeded inputs, its faults, and the port's command
line through it in processes where torch, jax and usearch12_tpu cannot be
imported, writing the JAX CLI's host paths' bytes.  Tolerance 0: every
compared value is an integer, a float32 score compared exactly, or a
byte."""

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

import usearch12_tpu.cli as jax_cli
from tests.test_sintax_device import _gen
from tests.test_torch_csr_rank import (_host_big_lists, _jax_rank,
                                       _port_setup, big_db, ranked_db)
from tests.test_torch_import import _run_blocked
from tests.test_torch_sintax import _chunk_inputs, _jax_chunk
from tests.test_torch_slice import gen_contigs
from tests.test_torch_cuda import ROOT, index_of, start_server, stop_server
from usearch12_tpu.align.oracle import banded_nw_main_diag
from usearch12_tpu.scoring import AlnParams as JaxAlnParams
from usearch12_tpu_torch import device_server as ds
from usearch12_tpu_torch.card import ServerCard
from usearch12_tpu_torch.config import reset_options
from usearch12_tpu_torch.ops.csr_host import CSRRanker
from usearch12_tpu_torch.scoring import AlnParams

__all__ = ["big_db", "ranked_db"]


BLOCKED = ["torch", "jax", "usearch12_tpu"]


CONV = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def short_tmp():
    """A directory under /tmp, short enough for AF_UNIX socket paths."""
    d = tempfile.mkdtemp(prefix="u12t-", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def server():
    d = tempfile.mkdtemp(prefix="u12t-", dir="/tmp")
    proc, cli = start_server(d)
    try:
        yield d, cli
    finally:
        stop_server(proc, cli)
        shutil.rmtree(d, ignore_errors=True)


def test_ping(server):
    d, cli = server
    rep = cli.ping()
    assert rep["device"] == "cpu"
    assert rep["digest"] == ds.code_digest()
    assert ds.server_paths(d).dir.endswith(rep["digest"])
    assert set(rep["served"]) == set(ds.OPS) and rep["served"]["ping"] >= 1
    assert rep["busy"] == 0
    # the kernels' plain versions launch no kernel
    assert rep["launches"] == {"wavefront_fwd": 0, "wavefront_trace": 0,
                               "sintax_pick_hist": 0,
                               "sintax_boot_count_select": 0}
    assert "torch_import_s" in rep["start"]
    card = ServerCard(cli)
    assert card.type == "cpu" and card.remote and not card.warm


@pytest.mark.parametrize("cls_bits", [0, 5])
def test_align_equals_jax_oracle(server, cls_bits):
    """Scores and paths of two terminal-penalty classes through the
    server card's aligner (one align_load a class, after the need_load of
    its first align) equal the JAX oracle's with the class's AlnParams
    (tests/test_device_server.py's pairs, with ends trimmed so that
    terminal gaps count)."""
    _d, cli = server
    rng = np.random.default_rng(3 + cls_bits)
    pairs = []
    for k in range(6):
        a = CONV[rng.integers(0, 4, 60)]
        b = a.copy()
        b[rng.integers(0, 60, 6)] = CONV[rng.integers(0, 4, 6)]
        pairs.append((a, b[k % 3:60 - k // 3]))
    n0 = cli.ping()["served"]
    reset_options()
    fa = ServerCard(cli).aligner(AlnParams.from_cmdline(True), cls_bits)
    scores, paths = fa.align(pairs, 8, nucleo=True)
    jap = JaxAlnParams.from_cmdline(nucleo=True).hole_params(
        *(bool(cls_bits & b) for b in (1, 2, 4, 8)))
    assert scores.dtype == np.float32 and len(paths) == len(pairs)
    for (a, b), s, p in zip(pairs, scores, paths):
        s0, p0 = banded_nw_main_diag(a, b, 8, jap)
        assert p == p0
        assert np.float32(s) == np.float32(s0)
    n1 = cli.ping()["served"]
    assert n1["align"] == n0["align"] + 2
    assert n1["align_load"] == n0["align_load"] + 1
    assert fa.align(pairs, 8, nucleo=True)[1] == paths
    assert cli.ping()["served"]["align"] == n0["align"] + 3


def test_csr_rank_equals_jax_at_or_below_big(server, ranked_db):
    """The host half on the server card's device half (csr_rank) equals
    the JAX CSRDeviceRanker's window on the CPU; the first chunk's
    need_load brings one csr_load."""
    _d, cli = server
    db_fa, q_fa = ranked_db
    _db, index, seqs, jbuf, j_off = _port_setup(db_fa, q_fa)
    n0 = cli.ping()["served"]
    ranker = CSRRanker(index, ServerCard(cli), topk=64)
    assert not ranker.big
    got = ranker.rank_window(jbuf, j_off)
    want = _jax_rank(db_fa, q_fa, [], jbuf, j_off)
    for name, x, y in zip(("cand", "cnts", "out_n", "uncertain"), got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    n1 = cli.ping()["served"]
    assert n1["csr_load"] == n0["csr_load"] + 1
    assert n1["csr_rank"] == n0["csr_rank"] + 1 + -(-len(seqs) // 64)


def test_csr_rank_above_big_equals_host_big(server, big_db):
    """Above -big (300 targets, -big 10) the server's ranker equals the
    port's host UDBSearchBig ranker (_rank_big_py), cut at K."""
    _d, cli = server
    db_fa, q_fa = big_db
    _db, index, seqs, jbuf, j_off = _port_setup(db_fa, q_fa,
                                                ["-big", "10"])
    ranker = CSRRanker(index, ServerCard(cli), topk=64, chunk_b=16)
    assert ranker.big
    cand, cnts, out_n, unc = ranker.rank_window(jbuf, j_off)
    assert not unc.any()
    for j, (tix, c) in enumerate(_host_big_lists(index, seqs, 64)):
        n = len(tix)
        assert out_n[j] == n and np.array_equal(cand[j, :n], tix), j
        assert np.array_equal(cnts[j, :n], c), j


def test_need_load_for_an_unknown_signature(server):
    _d, cli = server
    qw = np.zeros((4, 8), np.int64)
    assert cli._request({"op": "csr_rank", "sig": ("unknown",),
                         "args": (qw, 64)})["need_load"]
    assert cli._request({"op": "sintax_boots", "sig": ("unknown",),
                         "args": (qw,)})["need_load"]


@pytest.mark.parametrize("case", ["default_m32", "m_over_2048"])
def test_sintax_boots_equal_jax(server, case):
    """Winners and tops of one chunk on the server card's boot engine
    equal the JAX BootEngine.run_chunk's, m > 2048 included."""
    _d, cli = server
    db, chunk = _chunk_inputs(case)
    n0 = cli.ping()["served"]["sintax_load"]
    reset_options()
    eng = ServerCard(cli).boot_engine(index_of(*db[:4]), lambda: db[:4],
                                      db[4])
    assert eng.timer(True) is None and eng.launches == 0
    w, t = eng.run_chunk(*chunk)
    want = _jax_chunk(case)
    assert w.dtype == np.int32 and t.dtype == np.int32
    np.testing.assert_array_equal(w, want[0])
    np.testing.assert_array_equal(t, want[1])
    assert cli.ping()["served"]["sintax_load"] == n0 + 1


def test_bad_op_gets_an_error_and_the_server_serves_on(server):
    _d, cli = server
    with pytest.raises(ds.DeviceServerError, match="unknown op"):
        cli._request({"op": "nope"})
    with pytest.raises(ds.DeviceServerError, match="KeyError"):
        cli._request({"op": "align"})
    assert cli.ping()["busy"] == 0


def _client(tmp, code, args):
    """The port's command line in a process of its own with TMPDIR=tmp and
    torch, jax and usearch12_tpu blocked, after `code`."""
    script = ("import sys\n"
              f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
              + code +
              "from usearch12_tpu_torch.cli import main\n"
              f"sys.exit(main({args!r}))\n")
    env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT)
    env.pop("USEARCH_DEV_SERVER", None)
    return subprocess.run([sys.executable, "-c", script], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=300)


# the server shut down before the second window's card work: windows of 2
# queries (usearch_global) or 4 (sintax), and the hook on the method that
# sends each window's work
SHUT_DOWN_BEFORE_SECOND = """
from usearch12_tpu_torch import device_server
from usearch12_tpu_torch.amplicon import sintax, sintax_device
from usearch12_tpu_torch.engine import batch
run_file = batch.BatchEngine.run_file
batch.BatchEngine.run_file = lambda self, *a, **k: run_file(
    self, *a, window=2, **k)
sintax.WINDOW = 4
cls = {cls}
orig = cls.{meth}
calls = []
def second_without_server(self, *a, **k):
    if len(calls) == 1:
        assert device_server.shutdown_server() is not None
    calls.append(1)
    return orig(self, *a, **k)
cls.{meth} = second_without_server
"""


GONE_CASES = {
    "holes": ("contigs", "batch.BatchEngine", "search_window", [
        "-usearch_global", "q.fa", "-db", "t.fa", "-id", "0.5", "-strand",
        "plus", "-band", "120", "-dev_batch_cells", "1", "-threads", "1",
        "-blast6out", "out"]),
    "device_rank": ("sintax", "batch.BatchEngine", "search_window", [
        "-usearch_global", "q.fa", "-db", "db.fa", "-id", "0.9", "-strand",
        "plus", "-device_rank", "-blast6out", "out"]),
    "sintax": ("sintax", "sintax_device.SintaxTorchClassifier", "boots", [
        "-sintax", "q.fa", "-db", "db.fa", "-strand", "plus", "-boots", "10",
        "-sintax_device", "-tabbedout", "out"]),
}


def _jax_bytes(d, args, outs):
    cwd = os.getcwd()
    try:
        os.chdir(d)
        assert jax_cli.main(args + ["-quiet"]) == 0
    finally:
        os.chdir(cwd)
    return [open(os.path.join(d, o), "rb").read() for o in outs]


CLI_CASES = {
    # (inputs, port command line, JAX command line (host path), outputs,
    #  ops the server must have served)
    "usearch_global_holes": (
        "contigs",
        ["-usearch_global", "q.fa", "-db", "t.fa", "-id", "0.5", "-strand",
         "plus", "-band", "120", "-maxaccepts", "64", "-maxrejects", "64",
         "-dev_batch_cells", "1", "-blast6out", "g.b6", "-uc", "g.uc"],
        ["-no_engine_device"], ["g.b6", "g.uc"], ["align"]),
    "device_rank_big_10": (
        "amplicons",
        ["-usearch_global", "q.fa", "-db", "db.fa", "-id", "0.9", "-strand",
         "both", "-big", "10", "-device_rank", "-blast6out", "r.b6"],
        ["-no_device_rank"], ["r.b6"], ["csr_load", "csr_rank"]),
    "device_rank_default_big": (
        "amplicons",
        ["-usearch_global", "q.fa", "-db", "db.fa", "-id", "0.9", "-strand",
         "both", "-device_rank", "-blast6out", "r.b6"],
        ["-no_device_rank"], ["r.b6"], ["csr_load", "csr_rank"]),
    "sintax_device": (
        "sintax",
        ["-sintax", "q.fa", "-db", "db.fa", "-strand", "both", "-boots",
         "10", "-sintax_device", "-tabbedout", "tax.txt"],
        ["-no_sintax_device"], ["tax.txt"], ["sintax_load",
                                              "sintax_boots"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_through_the_server(server, case, tmp_path, monkeypatch):
    """The port's command line, torch, jax and usearch12_tpu blocked,
    with its card work on the server: the bytes of the JAX CLI's host
    path, and the server served it."""
    d, cli = server
    inputs, args, jax_flags, outs, ops = CLI_CASES[case]
    dirs = {k: tmp_path / k for k in ("port", "jax")}
    for p in dirs.values():
        p.mkdir()
        if inputs == "contigs":
            gen_contigs(str(p / "q.fa"), str(p / "t.fa"), n=3)
        elif inputs == "amplicons":
            from tests.genseqs import make_amplicons, write_fasta
            recs = make_amplicons(n_templates=80, reads_per_template=4,
                                  length=200, seed=43)
            write_fasta(str(p / "db.fa"), recs[:300])
            write_fasta(str(p / "q.fa"), recs[300:])
        else:
            _gen(p, n_db=40, n_q=12)
    n0 = cli.ping()["served"]
    monkeypatch.setenv("TMPDIR", d)
    monkeypatch.delenv("USEARCH_DEV_SERVER", raising=False)
    _run_blocked(str(dirs["port"]), BLOCKED, [args])
    jax_args = [a for a in args if a not in ("-device_rank",
                                             "-sintax_device",
                                             "-dev_batch_cells", "1")]
    want = _jax_bytes(str(dirs["jax"]), jax_args + jax_flags, outs)
    got = [(dirs["port"] / o).read_bytes() for o in outs]
    assert got == want and all(want)
    n1 = cli.ping()["served"]
    for op in ops:
        assert n1[op] > n0[op], op


def test_automatic_gates_take_a_live_server(server, ranked_db, tmp_path,
                                            monkeypatch):
    """With no device passed, the automatic gates (lowered here to the
    test's DBs) send the ranking and SINTAX's boots to a live server, with
    the host's bytes; where no server answers neither engages, and none is
    spawned."""
    import json
    import tempfile as tf
    import usearch12_tpu_torch.cli as port_cli
    from usearch12_tpu_torch import commands as port_commands
    from usearch12_tpu_torch.amplicon import sintax as port_sintax
    d, cli = server
    db_fa, q_fa = ranked_db
    _gen(tmp_path, n_db=40, n_q=12)
    monkeypatch.delenv("USEARCH_DEV_SERVER", raising=False)
    monkeypatch.setattr(port_commands, "AUTO_MIN_RANK_TARGETS", 80)
    monkeypatch.setattr(port_sintax, "AUTO_MIN_SERVER_TARGETS", 40)
    stats = tmp_path / "stats.jsonl"
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    # the holes stay on the host (a static gate of 10^12 cells): the hole
    # DP's adaptive gate follows the host rate it measured, kept in a file
    # that every run of the machine updates, and is not what this tests
    rank = ["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9", "-strand",
            "plus", "-quiet", "-dev_batch_cells", str(10 ** 12),
            "-blast6out"]
    sx = ["-sintax", str(tmp_path / "q.fa"), "-db", str(tmp_path / "db.fa"),
          "-strand", "both", "-boots", "10", "-quiet", "-tabbedout"]

    def run(args, name, *flags):
        out = tmp_path / name
        assert port_cli.main(args + [str(out)] + list(flags)) == 0
        return out.read_bytes(), json.loads(stats.read_text().splitlines()[-1])

    host_b6, _ = run(rank, "host.b6", "-no_device_rank")
    host_tab, _ = run(sx, "host.tab", "-no_sintax_device")
    empty = tf.mkdtemp(prefix="u12t-", dir="/tmp")
    try:
        for tmp, live in ((d, True), (empty, False)):
            monkeypatch.setattr(tf, "tempdir", tmp)
            n0 = cli.ping()["served"]
            b6, rec = run(rank, f"auto{live}.b6")
            assert b6 == host_b6
            assert rec["rank_device_jobs"] == (320 if live else 0)
            assert rec["server"] == live
            tab, rec = run(sx, f"auto{live}.tab")
            assert tab == host_tab
            assert rec["device"] == live
            n1 = cli.ping()["served"]
            assert (n1["csr_rank"] > n0["csr_rank"]) == live
            assert (n1["sintax_boots"] > n0["sintax_boots"]) == live
        assert os.listdir(empty) == []
    finally:
        shutil.rmtree(empty, ignore_errors=True)


def test_disabled_by_environment(monkeypatch, short_tmp):
    monkeypatch.setenv("USEARCH_DEV_SERVER", "0")
    assert ds.get_client(spawn=True) is None
    assert ds.connect(True, paths=ds.server_paths(short_tmp)) == (
        None, "USEARCH_DEV_SERVER=0")
    assert not os.listdir(short_tmp)


def test_server_of_other_code_is_not_used(monkeypatch, short_tmp):
    """A server that answers at this code's socket with another digest is
    neither used nor replaced by a spawn."""
    monkeypatch.delenv("USEARCH_DEV_SERVER", raising=False)
    paths = ds.server_paths(short_tmp)
    os.makedirs(paths.dir, mode=0o700)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(paths.sock)
    srv.listen(1)

    def answer():
        conn, _ = srv.accept()
        ds._recv_frame(conn)
        ds._send_frame(conn, {"ok": True, "pid": 1, "device": "cpu",
                              "digest": "0" * 16})
        conn.close()

    th = threading.Thread(target=answer)
    th.start()
    try:
        client, why = ds.connect(spawn=True, paths=paths)
    finally:
        th.join(10)
        srv.close()
    assert client is None and "runs other code" in why
    assert not os.path.exists(paths.lock)


def test_idle_exit(short_tmp):
    proc, cli = start_server(short_tmp, idle=1.0)
    try:
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert not os.path.exists(cli.paths.sock)
    with open(os.path.join(short_tmp, "server.out")) as f:
        assert "idle, exiting" in f.read()


@pytest.mark.parametrize("case", list(GONE_CASES))
def test_server_gone_between_windows_fails_the_command(short_tmp, case):
    """A server that ends after the first window fails the command (the
    hole DP, the ranking, SINTAX's boots): a non-zero exit and the error
    naming the server's log; nothing is done on the host instead."""
    inputs, cls, meth, args = GONE_CASES[case]
    if inputs == "contigs":
        gen_contigs(os.path.join(short_tmp, "q.fa"),
                    os.path.join(short_tmp, "t.fa"), n=4)
    else:
        _gen(__import__("pathlib").Path(short_tmp), n_db=20, n_q=8)
    proc, cli = start_server(short_tmp)
    try:
        r = _client(short_tmp, SHUT_DOWN_BEFORE_SECOND.format(
            cls=cls, meth=meth), args + ["-quiet"])
        assert proc.wait(timeout=20) == 0
    finally:
        stop_server(proc, cli)
    assert r.returncode != 0
    assert "DeviceServerError" in r.stderr
    assert f"its log: {cli.paths.log}" in r.stderr


def test_no_card_and_no_server_raises_after_saying_why(short_tmp):
    """-device_rank with no server and no card: the spawned server exits at
    its start (no CUDA device), the command says so on stderr, goes to the
    card in its own process and fails there, writing nothing."""
    _gen(__import__("pathlib").Path(short_tmp), n_db=20, n_q=4)
    env = dict(os.environ, TMPDIR=short_tmp, PYTHONPATH=ROOT)
    env.pop("USEARCH_DEV_SERVER", None)
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "usearch12_tpu_torch.cli", "-usearch_global",
         "q.fa", "-db", "db.fa", "-id", "0.9", "-strand", "plus",
         "-device_rank", "-blast6out", "r.b6", "-quiet"], cwd=short_tmp,
        env=env, capture_output=True, text=True, timeout=300)
    assert time.monotonic() - t0 < 60
    assert r.returncode != 0
    assert "not using the device server (the device server exited at its " \
        "start with code 1: device_server: no CUDA device" in r.stderr
    assert "RuntimeError: usearch12_tpu_torch needs a CUDA device" in r.stderr
    assert os.path.getsize(os.path.join(short_tmp, "r.b6")) == 0
    paths = ds.server_paths(short_tmp)
    assert not os.path.exists(paths.lock) and not os.path.exists(paths.sock)


def test_short_reads_need_no_torch_and_no_server(short_tmp):
    """usearch_global of amplicon reads with no server and no card: no hole
    reaches the device, so the factory never runs (no server is spawned)
    and the process imports no torch; the JAX CLI's bytes."""
    from tests.genseqs import make_amplicons, write_fasta
    recs = make_amplicons(n_templates=40, reads_per_template=3, length=250,
                          seed=5)
    write_fasta(os.path.join(short_tmp, "db.fa"), recs[:60])
    write_fasta(os.path.join(short_tmp, "q.fa"), recs[60:])
    args = ["-usearch_global", "q.fa", "-db", "db.fa", "-id", "0.9",
            "-strand", "both", "-blast6out", "s.b6", "-quiet"]
    r = _client(short_tmp, "", args)
    assert r.returncode == 0, r.stderr
    assert r.stderr == ""
    assert not os.path.exists(ds.server_paths(short_tmp).dir)
    got = open(os.path.join(short_tmp, "s.b6"), "rb").read()
    os.rename(os.path.join(short_tmp, "s.b6"),
              os.path.join(short_tmp, "port.b6"))
    assert got and got == _jax_bytes(short_tmp, args[:-1], ["s.b6"])[0]
