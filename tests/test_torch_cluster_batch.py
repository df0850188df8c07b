"""usearch12_tpu_torch's cluster_mt -mesh (parallel/cluster_batch.py) on
the CPU, where the mesh's entries are the CPU and the int8 products run as
torch ops on CPU tensors.

DeviceUCounter.count is held to the JAX package's DeviceUCounter.count
(on its virtual CPU meshes) through every branch of refresh; the batched
command's -uc and -centroids bytes to the port's host cluster_mt and to
the JAX package's cluster_mt_batched, to the host path above -big (where
the JAX package differs), and across a -checkpoint resume.  Tolerance 0:
every compared value is an integer count or a byte."""

import json

import numpy as np
import pytest
import torch

import usearch12_tpu.cli as jax_cli
import usearch12_tpu_torch.cli as port_cli
from tests.genseqs import make_amplicons, write_fasta
from usearch12_tpu_torch.parallel import cluster_batch
from usearch12_tpu_torch.parallel.mesh import single_mesh

CPU = torch.device("cpu")
MESHES = {"1x1": (1, 1), "2x4": (2, 4)}


def _jax_mesh(n_data, n_db):
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:n_data * n_db])
    return Mesh(devs.reshape(n_data, n_db), ("data", "db"))


def _indexes(seqs):
    """Empty UDB indexes of both packages and a function adding seqs to
    both (as centroids are admitted)."""
    from usearch12_tpu.index.udb import UDBIndex as JIndex, UDBParams as JP
    from usearch12_tpu_torch.index.udb import UDBIndex, UDBParams
    port, jx = UDBIndex(UDBParams.global_usearch(True)), JIndex(
        JP.global_usearch(True))

    def add(new):
        for s in new:
            for ix in (port, jx):
                ci = ix.seq_count
                ix.add_seq(ci, s)
                ix.seq_count = ci + 1
    return port, jx, add


@pytest.mark.parametrize("shape", list(MESHES))
def test_counter_equals_jax_through_every_refresh(shape):
    """count() after each refresh branch: empty, first allocation, rows
    written in place, a capacity regrown, an index with fewer centroids
    (t < _t), and empty again; on both packages' meshes of this shape."""
    from usearch12_tpu.parallel.cluster_batch import DeviceUCounter as JC
    port_cli.parse_argv(["-cluster_mt", "x.fa", "-id", "0.97", "-quiet"])
    recs = make_amplicons(n_templates=12, reads_per_template=4, length=200,
                          seed=29)
    seqs = [np.frombuffer(s.encode(), np.uint8) for _l, s in recs]
    queries = seqs[:30]
    n_data, n_db = MESHES[shape]
    port_c = cluster_batch.DeviceUCounter(single_mesh(CPU, n_db, n_data))
    jax_c = JC(_jax_mesh(n_data, n_db))
    port_ix, jax_ix, add = _indexes(seqs)

    def step(new, note=True, port_ix=port_ix, jax_ix=jax_ix):
        add(new)
        if note and new:
            port_c.note_admitted(port_ix, new)
            jax_c.note_admitted(jax_ix, new)
        port_c.refresh(port_ix)
        jax_c.refresh(jax_ix)
        got = port_c.count(port_ix, queries)
        want = jax_c.count(jax_ix, queries)
        assert got.dtype == want.dtype == np.uint32
        assert got.shape == want.shape == (30, port_ix.seq_count)
        assert np.array_equal(got, want)
        return got

    step([])                                  # empty
    step(seqs[:5])                            # first allocation
    assert port_c.stats["allocs"] == 1 and port_c.cap >= 1024
    u = step(seqs[5:8])                       # in place
    assert port_c.stats["allocs"] == 1 and u.max() > 0
    # a small capacity, then more centroids than it holds: regrown
    port_c._alloc(port_ix, 8)
    jax_c._alloc(jax_ix, 8)
    assert port_c.cap == 8 * n_db
    step(seqs[8:48])
    assert port_c.stats["allocs"] == 3 and port_c.cap >= 1024
    # an index with fewer centroids than the incidence holds
    few_p, few_j, add_few = _indexes(seqs)
    add_few(seqs[40:43])
    port_c.refresh(few_p)
    jax_c.refresh(few_j)
    assert np.array_equal(port_c.count(few_p, queries),
                          jax_c.count(few_j, queries))
    assert port_c.stats["allocs"] == 4
    empty_p, empty_j, _ = _indexes(seqs)      # empty again
    port_c.refresh(empty_p)
    jax_c.refresh(empty_j)
    assert port_c.count(empty_p, queries).shape == (30, 0)
    assert jax_c.count(empty_j, queries).shape == (30, 0)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("cmt")
    path = str(d / "reads.fa")
    write_fasta(path, make_amplicons(n_templates=30, reads_per_template=5,
                                     length=220, seed=31))
    return path


def _cluster(main, d, reads, extra, **kw):
    """-uc and -centroids bytes of one cluster_mt command line in d."""
    uc, cent = str(d / "c.uc"), str(d / "c.fa")
    assert main(["-cluster_mt", reads, "-id", "0.97", "-uc", uc,
                 "-centroids", cent, "-quiet"] + extra, **kw) == 0
    return open(uc, "rb").read(), open(cent, "rb").read()


def _stats(path):
    return json.loads(path.read_text().splitlines()[-1])


@pytest.mark.parametrize("mesh", ["1", "2x4"])
def test_batched_bytes_equal_host_and_jax(reads, tmp_path, monkeypatch,
                                          mesh):
    """-maxpending 8: the port's -mesh run writes the bytes of its host
    cluster_mt and of the JAX package's cluster_mt_batched (on one device:
    on 2x4 it fails here, see the next test)."""
    opts = ["-maxpending", "8"]
    for k in ("host", "mesh", "jax"):
        (tmp_path / k).mkdir()
    host = _cluster(port_cli.main, tmp_path / "host", reads, opts,
                    device="cpu")
    stats = tmp_path / "stats.jsonl"
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    got = _cluster(port_cli.main, tmp_path / "mesh", reads,
                   opts + ["-mesh", mesh], device="cpu")
    monkeypatch.delenv("USEARCH_DEVICE_STATS")
    want = _cluster(jax_cli.main, tmp_path / "jax", reads,
                    opts + ["-mesh", "1"])
    assert got == host == want
    assert got[0].count(b"S\t") > 8 and got[0].count(b"H\t") > 8
    ds = _stats(stats)
    assert ds["flushes"] > 1 and ds["windows"] > ds["flushes"]
    assert ds["host_ranked"] == 0 and ds["queries"] == 180
    assert ds["centroids"] == got[0].count(b"S\t")


def test_jax_data_axis_fails_on_odd_windows(reads, tmp_path):
    """The JAX package's cluster_mt_batched puts each window's query rows
    on its "data" axis unpadded, so on a 2x4 mesh a window of an odd
    number of queries (here 5, after a flush) raises in jax.device_put;
    the port pads the rows and writes the host path's bytes."""
    opts = ["-maxpending", "8", "-mesh", "2x4"]
    for k in ("port", "jax"):
        (tmp_path / k).mkdir()
    with pytest.raises(ValueError, match="divisible by 2"):
        _cluster(jax_cli.main, tmp_path / "jax", reads, opts)
    got = _cluster(port_cli.main, tmp_path / "port", reads, opts,
                   device="cpu")
    assert got == _cluster(port_cli.main, tmp_path / "port", reads,
                           opts[:2], device="cpu")


@pytest.fixture(scope="module")
def reads_2400(tmp_path_factory):
    """bench.py's amplicon reads: 400 templates of 250 nt and 5 reads of
    each, seed 11."""
    path = str(tmp_path_factory.mktemp("cmt_big") / "reads.fa")
    write_fasta(path, make_amplicons(n_templates=400, reads_per_template=5,
                                     length=250, seed=11))
    return path


def test_above_big_equals_host_where_jax_differs(reads_2400, tmp_path,
                                                 monkeypatch):
    """-big 50: above 50 centroids the port ranks as its host cluster_mt
    does (UDBSearchBig), and writes its bytes; the JAX package's
    cluster_mt_batched ranks with SetTopBump there and writes others."""
    opts = ["-big", "50"]
    for k in ("host", "mesh", "jax"):
        (tmp_path / k).mkdir()
    host = _cluster(port_cli.main, tmp_path / "host", reads_2400, opts,
                    device="cpu")
    stats = tmp_path / "stats.jsonl"
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    got = _cluster(port_cli.main, tmp_path / "mesh", reads_2400,
                   opts + ["-mesh", "1"], device="cpu")
    monkeypatch.delenv("USEARCH_DEVICE_STATS")
    jax_uc, _jax_fa = _cluster(jax_cli.main, tmp_path / "jax", reads_2400,
                               opts + ["-mesh", "1"])
    assert got == host
    ds = _stats(stats)
    assert 0 < ds["host_ranked"] < ds["queries"] == 2400
    assert jax_uc != host[0]


class _Interrupted(Exception):
    pass


@pytest.mark.parametrize("saves", [1, 2])
def test_checkpoint_resume(reads, tmp_path, monkeypatch, saves):
    """A run interrupted after `saves` checkpoints (and after writing -uc
    records past the last one) resumes from its -checkpoint file and
    writes the bytes of an uninterrupted run."""
    opts = ["-maxpending", "8", "-mesh", "2x4"]
    (tmp_path / "whole").mkdir()
    whole = _cluster(port_cli.main, tmp_path / "whole", reads, opts,
                     device="cpu")
    d = tmp_path / "resumed"
    d.mkdir()
    ckpt = str(d / "run.ckpt")
    save = cluster_batch._save_checkpoint
    n = [0]

    def save_then_stop(*a):
        if n[0] == saves:
            raise _Interrupted
        n[0] += 1
        save(*a)

    monkeypatch.setattr(cluster_batch, "_save_checkpoint", save_then_stop)
    with pytest.raises(_Interrupted):
        _cluster(port_cli.main, d, reads, opts + ["-checkpoint", ckpt],
                 device="cpu")
    monkeypatch.setattr(cluster_batch, "_save_checkpoint", save)
    data = np.load(ckpt, allow_pickle=True)
    assert len(data["labels"]) > 0
    # records past the checkpoint were written and must be dropped
    assert (d / "c.uc").stat().st_size > int(data["uc_offset"])
    assert _cluster(port_cli.main, d, reads, opts + ["-checkpoint", ckpt],
                    device="cpu") == whole
