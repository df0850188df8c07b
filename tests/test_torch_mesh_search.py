"""usearch12_tpu_torch's usearch_global -mesh (parallel/mesh_search.py) on
the CPU, where the mesh's entries are the CPU and the shards' products,
prefix maxima and top K run as torch ops on CPU tensors.

At or below -big the port's MeshRanker is held to its host ranker
(USortedRanker) and to the JAX package's MeshRanker (on its virtual CPU
meshes), on amplicon queries and on a DB built to put equal and nearly
equal counts on both sides of the shard borders; above -big to its host
ranker.  The command line's outputs under -mesh equal the JAX CLI's and
the -mesh-less run's, and its -mesh errors are the JAX CLI's.  Tolerance
0: every compared value is an integer or a byte."""

import numpy as np
import pytest
import torch

import usearch12_tpu.cli as jax_cli
import usearch12_tpu_torch.cli as port_cli
from tests.genseqs import make_amplicons, write_fasta
from usearch12_tpu_torch.parallel.mesh import single_mesh
from usearch12_tpu_torch.parallel.mesh_search import MeshRanker

CPU = torch.device("cpu")
MESHES = {"1x1": (1, 1), "1x4": (1, 4), "2x4": (2, 4)}


@pytest.fixture(scope="module")
def amplicon_db(tmp_path_factory):
    """tests/test_mesh_search.py's fixture: 60 templates as the DB, their
    240 reads as the queries."""
    d = tmp_path_factory.mktemp("mesh")
    recs = make_amplicons(n_templates=60, reads_per_template=4, length=220,
                          seed=19)
    db_fa, q_fa = str(d / "db.fa"), str(d / "q.fa")
    write_fasta(db_fa, [r for r in recs if r[0].startswith("tpl")])
    write_fasta(q_fa, [r for r in recs if not r[0].startswith("tpl")])
    return db_fa, q_fa


@pytest.fixture(scope="module")
def tied_db(tmp_path_factory):
    """96 targets, 24 to a shard on a 1x4 mesh: template k at 0 <= k < 24
    and exact copies at k + 24 and k + 48 (equal counts at the same place
    in three shards), a copy with 1-3 substitutions at k + 72 (nearly
    equal); 80 queries, reads of the templates with 0-6 substitutions."""
    d = tmp_path_factory.mktemp("mesh_ties")
    rng = np.random.default_rng(53)
    conv = np.frombuffer(b"ACGT", np.uint8)
    tpls = [conv[rng.integers(0, 4, 200)] for _ in range(24)]

    def sub(s, n):
        s = s.copy()
        s[rng.integers(0, len(s), n)] = conv[rng.integers(0, 4, n)]
        return s
    targets = tpls * 3 + [sub(t, int(rng.integers(1, 4))) for t in tpls]
    queries = [sub(tpls[k % 24], int(rng.integers(0, 7))) for k in range(80)]
    db_fa, q_fa = str(d / "db.fa"), str(d / "q.fa")
    for path, seqs, tag in ((db_fa, targets, "t"), (q_fa, queries, "q")):
        write_fasta(path, [(f"{tag}{i}", s.tobytes().decode())
                           for i, s in enumerate(seqs)])
    return db_fa, q_fa


def _window(q_fa):
    from usearch12_tpu_torch.io.fastx import read_fastx
    seqs = [s for _l, s, _q in read_fastx(q_fa, stream=True)]
    jbuf = np.ascontiguousarray(np.concatenate(seqs))
    j_off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=j_off[1:])
    return seqs, jbuf, j_off


def _args(q_fa, db_fa, extra):
    return ["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9", "-strand",
            "plus", "-quiet", *extra]


def _port_rank(db_fa, q_fa, extra, shape, topk, **kw):
    """The port's MeshRanker (kw: its chunk_elems) and host ranker on the
    queries as one window."""
    from usearch12_tpu_torch.index.udb import UDBIndex
    from usearch12_tpu_torch.io.seqdb import SeqDB
    from usearch12_tpu_torch.search.usorted import USortedRanker
    port_cli.parse_argv(_args(q_fa, db_fa, extra))
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    index = UDBIndex.from_seqdb(db)
    seqs, jbuf, j_off = _window(q_fa)
    n_data, n_db = MESHES[shape]
    ranker = MeshRanker(single_mesh(CPU, n_db, n_data), index, topk=topk,
                        **kw)
    host = [USortedRanker(index).rank(s) for s in seqs]
    return ranker, ranker.rank_window(jbuf, j_off), host


def _jax_rank(db_fa, q_fa, extra, shape, topk):
    import jax
    from jax.sharding import Mesh
    from usearch12_tpu.index.udb import UDBIndex
    from usearch12_tpu.io.seqdb import SeqDB
    from usearch12_tpu.parallel.mesh_search import MeshRanker as JMR
    jax_cli.parse_argv(_args(q_fa, db_fa, extra))
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    n_data, n_db = MESHES[shape]
    mesh = Mesh(np.array(jax.devices()[:n_data * n_db]).reshape(
        n_data, n_db), ("data", "db"))
    _seqs, jbuf, j_off = _window(q_fa)
    return JMR(mesh, UDBIndex.from_seqdb(db), topk=topk).rank_window(
        jbuf, j_off)


def _assert_equals_host(out, host, topk):
    cand, cnts, out_n, _unc = out
    for j, (tix, c) in enumerate(host):
        n = min(len(tix), topk)
        assert out_n[j] == n, (j, out_n[j], n)
        assert np.array_equal(cand[j, :n], tix[:n]), j
        assert np.array_equal(cnts[j, :n], c[:n]), j


def _assert_equals_jax(out, want):
    cand, cnts, out_n, unc = out
    w_cand, w_cnts, w_out_n, w_unc = want
    assert np.array_equal(out_n, w_out_n)
    assert np.array_equal(unc, w_unc)
    for j, n in enumerate(out_n):
        assert np.array_equal(cand[j, :n], w_cand[j, :n]), j
        assert np.array_equal(cnts[j, :n], w_cnts[j, :n]), j


@pytest.mark.parametrize("bump", [None, "0"])
@pytest.mark.parametrize("shape", list(MESHES))
def test_ranker_equals_host_and_jax(amplicon_db, shape, bump):
    """60 targets, 240 queries, K 32: every candidate list, count and list
    length of the port's MeshRanker equals its host ranker's and the JAX
    MeshRanker's, with -bump 0 and the default."""
    db_fa, q_fa = amplicon_db
    extra = ["-bump", bump] if bump else []
    ranker, out, host = _port_rank(db_fa, q_fa, extra, shape, 32)
    assert not ranker.big and ranker.t == 60
    _assert_equals_host(out, host, 32)
    _assert_equals_jax(out, _jax_rank(db_fa, q_fa, extra, shape, 32))
    assert ranker.overhead["windows"] == 1
    assert ranker.overhead["dispatches"] >= MESHES[shape][0]


@pytest.mark.parametrize("topk", [4, 64])
@pytest.mark.parametrize("shape", ["1x4", "2x4"])
def test_ties_across_shard_borders(tied_db, shape, topk):
    """Equal counts at the same place of three shards and near ties in the
    fourth: the merged order is count desc, target asc, as the host's
    count sort and the JAX merge give it; at K 4 the lists are cut inside
    the tied blocks.  Chunks of 24 query rows (4 a window on 1x4, 2 a
    data row on 2x4)."""
    db_fa, q_fa = tied_db
    ranker, out, host = _port_rank(db_fa, q_fa, [], shape, topk,
                                   chunk_elems=24 * 96)
    assert ranker.t_shard == 24 and ranker.chunk_rows == 24
    assert ranker.overhead["dispatches"] == 4
    _assert_equals_host(out, host, topk)
    _assert_equals_jax(out, _jax_rank(db_fa, q_fa, [], shape, topk))
    cand, cnts, out_n, _unc = out
    # the tie is real: each query's top counts are shared by three shards
    tied = sum(int(out_n[j] >= 3 and cnts[j, 0] == cnts[j, 2]
                   and len({int(t) // 24 for t in cand[j, :3]}) == 3)
               for j in range(len(out_n)))
    assert tied >= 40


def test_above_big_equals_host(tied_db):
    """-big 10: 96 targets rank as UDBSearchBig (on the port's CSR ranker),
    equal to the host ranker on every query; the JAX MeshRanker ranks with
    SetTopBump there, and its lists differ from the host's."""
    db_fa, q_fa = tied_db
    ranker, out, host = _port_rank(db_fa, q_fa, ["-big", "10"], "1x4", 64)
    assert ranker.big
    _assert_equals_host(out, host, 64)
    j_cand, _c, j_out_n, _u = _jax_rank(db_fa, q_fa, ["-big", "10"], "1x4",
                                        64)
    differ = sum(int(j_out_n[j] != min(len(t), 64)
                     or not np.array_equal(j_cand[j, :j_out_n[j]],
                                           t[:j_out_n[j]]))
                 for j, (t, _c) in enumerate(host))
    assert differ > 0


def _search(main, d, q_fa, db_fa, extra, outs, **kw):
    paths = [str(d / o) for o in outs]
    flags = {"b6": "-blast6out", "uc": "-uc", "user": "-userout"}
    args = ["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9", "-strand",
            "both", "-quiet", "-userfields", "query+target+id+qlo+qhi+tlo"]
    for o, p in zip(outs, paths):
        args += [flags[o.split(".")[1]], p]
    assert main(args + extra, **kw) == 0
    return [open(p, "rb").read() for p in paths]


@pytest.mark.parametrize("outs", [["h.b6"], ["h.b6", "h.uc", "h.user"]])
def test_cli_outputs_equal_jax_and_host(amplicon_db, tmp_path, outs):
    """-mesh 2x4 through the CLI: blast6 alone (the packed emitter) and
    with -uc and -userout, equal to the JAX CLI's -mesh 2x4 and to the
    port's run without -mesh."""
    db_fa, q_fa = amplicon_db
    for k in ("mesh", "host", "jax"):
        (tmp_path / k).mkdir()
    got = _search(port_cli.main, tmp_path / "mesh", q_fa, db_fa,
                  ["-mesh", "2x4"], outs, device="cpu")
    host = _search(port_cli.main, tmp_path / "host", q_fa, db_fa,
                   ["-no_engine_device"], outs, device="cpu")
    want = _search(jax_cli.main, tmp_path / "jax", q_fa, db_fa,
                   ["-mesh", "2x4"], outs)
    assert got == host == want
    assert all(got) and got[0].count(b"\n") >= 240


def test_cli_above_big_equals_host(tied_db, tmp_path):
    """-mesh 1x4 -big 10 through the CLI: the bytes of the port's host
    path, which ranks with UDBSearchBig there."""
    db_fa, q_fa = tied_db
    outs = ["h.b6", "h.uc"]
    for k in ("mesh", "host"):
        (tmp_path / k).mkdir()
    got = _search(port_cli.main, tmp_path / "mesh", q_fa, db_fa,
                  ["-mesh", "1x4", "-big", "10"], outs, device="cpu")
    assert got == _search(port_cli.main, tmp_path / "host", q_fa, db_fa,
                          ["-no_engine_device", "-big", "10"], outs,
                          device="cpu")
    assert got[0].count(b"\n") >= 80


@pytest.mark.parametrize("extra", [["-mesh", "abc"], ["-mesh", "2xq"],
                                   ["-mesh", "1", "-quicksort"]])
def test_mesh_errors_equal_jax(amplicon_db, tmp_path, extra):
    """A -mesh value that does not parse, and -mesh on a run the engine
    does not take: the JAX CLI's SystemExit text (exit status 1)."""
    db_fa, q_fa = amplicon_db
    args = ["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9", "-strand",
            "plus", "-quiet", "-blast6out", str(tmp_path / "x.b6"), *extra]
    with pytest.raises(SystemExit) as got:
        port_cli.main(args, device="cpu")
    with pytest.raises(SystemExit) as want:
        jax_cli.main(args)
    assert isinstance(got.value.code, str)
    assert got.value.code == want.value.code
    assert got.value.code.startswith("-mesh")


def test_mesh_needs_the_cards_it_names(amplicon_db, tmp_path, monkeypatch):
    """On the card, -mesh 4x4 with 8 cards exits as the JAX CLI does on its
    8 virtual devices; -mesh 2 on the CPU is any shape's CPU mesh."""
    db_fa, q_fa = amplicon_db
    args = ["-cluster_mt", q_fa, "-id", "0.97", "-quiet", "-mesh", "4x4"]
    with pytest.raises(SystemExit) as want:
        jax_cli.main(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(SystemExit) as got:
        port_cli.main(args)
    assert got.value.code == want.value.code == \
        "-mesh 4x4: needs 16 devices, have 8"
    from usearch12_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh("8", torch.device("cpu"))
    assert mesh.shape == {"data": 2, "db": 4}
    assert make_mesh("auto", "cpu").shape == {"data": 1, "db": 1}
    four = make_mesh("4", "cuda")     # factored db-major: 2x2
    assert four.shape == {"data": 2, "db": 2}
    assert four.devices[1, 1] == torch.device("cuda", 3)
