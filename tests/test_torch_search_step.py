"""usearch12_tpu_torch's search step (parallel/search_step.py), its
sharded hole DP (TorchWaveAligner.align_sharded) and its entry points
(entry.py) on the CPU, held against the JAX package's
(usearch12_tpu/parallel/search_step.py, __graft_entry__.py; JAX on its 8
virtual CPU devices) on the same numpy inputs from a seed.

Counts and tops are integers and must be equal; scores are float32 and
must be bit-equal wherever the JAX step is right (dyadic gap penalties,
bands of up to 128 lanes, queries of A, C, G and T).  Where it is not,
the port equals align/oracle.py and a test pins the JAX step's
difference.  Tolerance 0 everywhere."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import __graft_entry__ as jax_entry
from usearch12_tpu.align.oracle import banded_nw as jax_oracle
from usearch12_tpu.ops.banded_nw import _letters
from usearch12_tpu.parallel import search_step as jss
from usearch12_tpu.scoring import AlnParams, nuc_mx
from usearch12_tpu_torch import entry as port_entry
from usearch12_tpu_torch.ops.wavefront_nw import (TorchWaveAligner,
                                                  gap_params, native_nw_band,
                                                  nucleo_params)
from usearch12_tpu_torch.parallel import search_step as pss
from usearch12_tpu_torch.parallel.mesh import Mesh, single_mesh

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
DYADIC = (-10.0, -1.0, -0.5, -0.5)
NON_DYADIC = (-10.3, -1.1, -0.7, -0.4)
NEG = np.float32(-9e9)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _jax_step(args, mesh=None):
    """The JAX step (or its sharded form over `mesh`) on numpy args."""
    if mesh is None:
        return [np.asarray(x) for x in jax.jit(jss.make_search_step())(*args)]
    with mesh:
        fn = jax.jit(jss.make_sharded_search_step(mesh))
        return [np.asarray(x) for x in fn(*(jax.numpy.asarray(a)
                                            for a in args))]


def _port_args_from_jax(args):
    """The port's step arguments from the JAX step's numpy arguments: int8
    target-major incidence, letter rows padded with PAD_LETTER after each
    query's last letter below 4 and after each target's db_len letters
    (the JAX rows pad with 4)."""
    qo, db_mat, a_cls, db_cls, db_len, gp = args
    v = qo.shape[1]
    v_pad = v + (-v) % 8
    t = db_mat.shape[1]
    q = np.zeros((len(qo), v_pad), np.int8)
    q[:, :v] = qo
    w = np.zeros((t + (-t) % 8, v_pad), np.int8)
    w[:t, :v] = db_mat.T

    def pad(cls, n):
        return np.where(np.arange(cls.shape[1])[None, :] < n[:, None], cls,
                        pss.PAD_LETTER).astype(np.uint8)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        q, w, pad(a_cls, (a_cls < 4).sum(1)), pad(db_cls, db_len),
        db_len.astype(np.int32), gp))


def _assert_same(jax_out, port_out, scores=True):
    jc, jt, js = jax_out
    pc, pt, ps = (x.numpy() for x in port_out)
    np.testing.assert_array_equal(jc.astype(np.int64), pc)
    np.testing.assert_array_equal(jt, pt)
    if scores:
        np.testing.assert_array_equal(_bits(js), _bits(ps))


def _tie_data(seed=31, n_targets=16, n_queries=24):
    """The entry's data with targets k and k + n_targets/2 (and k + 4, for
    k % 8 < 4) identical: equal top counts within a shard and across
    shards of every mesh tested."""
    rng = np.random.default_rng(seed)
    tpls = [ACGT[rng.integers(0, 4, 200)] for _ in range(4)]
    targets = [tpls[k % 4].copy() for k in range(n_targets)]
    for k in range(n_targets):
        if k % 8 >= 4 and k < n_targets // 2:
            targets[k][rng.integers(0, 200, 6)] = ACGT[rng.integers(0, 4, 6)]
    for k in range(n_targets // 2, n_targets):
        targets[k] = targets[k - n_targets // 2].copy()
    queries = []
    for q in range(n_queries):
        s = targets[q % n_targets].copy()
        s[rng.integers(0, 200, 5)] = ACGT[rng.integers(0, 4, 5)]
        queries.append(s)
    return _pair_args(queries, targets, word_length=5)


def _pair_args(queries, targets, word_length=None, pen=DYADIC):
    """JAX step arguments for queries against targets with a real word
    incidence (word_length given) or an identity one (query k's only
    candidate is target k)."""
    from usearch12_tpu.index.udb import UDBIndex, UDBParams
    from usearch12_tpu.io.seqdb import SeqDB
    if word_length is None:
        n = len(queries)
        qo = db_mat = np.eye(n, dtype=np.float32)
    else:
        db = SeqDB()
        for k, s in enumerate(targets):
            db.add(f"t{k}", s)
        db.set_is_nucleo(True)
        index = UDBIndex.from_seqdb(db, UDBParams.global_usearch(
            True, word_length=word_length))
        qo = jss.query_onehot(index, queries, 256)
        db_mat = jss.build_incidence(index)
    a_cls = np.full((len(queries), 256), 4, np.int32)
    db_cls = np.full((len(targets), 256), 4, np.int32)
    for k, s in enumerate(queries):
        a_cls[k, :len(s)] = _letters(s, True)
    for k, s in enumerate(targets):
        db_cls[k, :len(s)] = _letters(s, True)
    db_len = np.array([len(s) for s in targets], np.int32)
    gp = gap_params(nucleo_params(*pen))[:12].numpy()
    return qo, db_mat, a_cls, db_cls, db_len, gp


def _oracle_scores(queries, targets, pen):
    """align/oracle.py in the step's band, for each (query, target)."""
    ap = AlnParams(nucleo=True, subst_mx=nuc_mx(1.0, -2.0))
    ap.init4(*pen)
    out = []
    for a, b in zip(queries, targets):
        la, lb = len(a), len(b)
        dlo = max(min(la, lb) - 16, 1)
        dhi = min(max(la, lb) + 16, la + lb - 1)
        out.append(jax_oracle(a, b, dlo, dhi, ap)[0])
    return np.array(out, np.float32)


def _pairs(seed, n, la, lb, n_sub=8, n_n=0):
    """n (query, target) pairs: the target a copy of the query cut or
    extended to lb with n_sub substitutions, the query with n_n Ns."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(n):
        a = ACGT[rng.integers(0, 4, la)]
        b = a[:lb].copy() if lb <= la else np.concatenate(
            [a, ACGT[rng.integers(0, 4, lb - la)]])
        b[rng.integers(0, lb, n_sub)] = ACGT[rng.integers(0, 4, n_sub)]
        if n_n:
            a = a.copy()
            a[rng.integers(10, la - 10, n_n)] = ord("N")
        qs.append(a)
        ts.append(b)
    return qs, ts


# -- the single-device step ----------------------------------------------

@pytest.mark.parametrize("seed", [3, 5, 7])
def test_search_step_matches_jax(seed):
    """The entry's data from the same seed: the port's _example_data equals
    the JAX one, and the port's step the JAX step (counts, tops, scores
    bit-equal)."""
    jargs = jax_entry._example_data(seed=seed)
    pargs = port_entry._example_data(seed=seed, device=CPU)
    for x, y in zip(_port_args_from_jax(jargs), pargs):
        assert torch.equal(x, y)
    out = pss.make_search_step(256, CPU)(*pargs)
    _assert_same(_jax_step(jargs), out)
    assert out[0].dtype == torch.int32 and out[2].dtype == torch.float32


def test_search_step_ties_match_jax():
    """Equal top counts: the lowest target index wins in both steps."""
    jargs = _tie_data()
    jout = _jax_step(jargs)
    u = jargs[0] @ jargs[1]
    assert ((u == u.max(1, keepdims=True)).sum(1) >= 2).all()
    _assert_same(jout, pss.make_search_step(256, CPU)(
        *_port_args_from_jax(jargs)))


def test_search_step_chunks_rows(monkeypatch):
    """U in chunks of rows (here 24 rows a chunk), on one device and over
    a mesh, gives the one-chunk step's outputs."""
    pargs = port_entry._example_data(n_queries=50, seed=5, device=CPU)
    one = pss.make_search_step(256, CPU)(*pargs)
    monkeypatch.setattr(pss, "CHUNK_ELEMS", 24 * 16)
    assert pss._chunk_rows(16) == 24
    for step in (pss.make_search_step(256, CPU),
                 pss.make_sharded_search_step(single_mesh(CPU, 2, 2), 256)):
        for x, y in zip(one, step(*pargs)):
            assert torch.equal(x, y)


# -- the sharded step ----------------------------------------------------

MESHES = {"1x8": (1, 8), "2x4": (2, 4), "4x2": (4, 2)}


@pytest.mark.parametrize("shape", list(MESHES))
def test_sharded_step_matches_jax(shape):
    """The JAX dry run's data (and the tie data) on the JAX mesh and on the
    port's CPU mesh of the same shape; both equal the single-device
    step."""
    n_data, n_db = MESHES[shape]
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(n_data, n_db),
                    ("data", "db"))
    pmesh = single_mesh(CPU, n_db, n_data)
    step = pss.make_sharded_search_step(pmesh, 256)
    for jargs in (jax_entry._example_data(n_queries=2 * n_data * 4,
                                          n_targets=4 * n_db),
                  _tie_data(n_queries=8 * n_data)):
        pargs = _port_args_from_jax(jargs)
        out = step(*pargs)
        _assert_same(_jax_step(jargs, jmesh), out)
        for x, y in zip(out, pss.make_search_step(256, CPU)(*pargs)):
            assert torch.equal(x, y)


def test_sharded_step_pads_odd_rows_where_jax_raises():
    """9 query rows on a 2x4 mesh: the JAX step cannot split them over
    "data" and raises; the port pads the rows and equals the
    single-device step (and 20 targets, which do not divide by "db")."""
    jargs = jax_entry._example_data(n_queries=9, n_targets=20, seed=7)
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4),
                    ("data", "db"))
    with pytest.raises(ValueError):
        _jax_step(jargs, jmesh)
    pargs = port_entry._example_data(n_queries=9, n_targets=20, seed=7,
                                     device=CPU)
    out = pss.make_sharded_search_step(single_mesh(CPU, 4, 2), 256)(*pargs)
    _assert_same(_jax_step(jargs), out)


# -- the score -----------------------------------------------------------

def _jax_score(a_cls, b_cls, la, lb, dlo, bw, gp):
    """banded_nw_score_jnp with its B row pre-shifted as the JAX step
    shifts it."""
    m = np.arange(a_cls.shape[1] + 128)[None, :]
    src = m - (la - dlo)[:, None]
    bs = np.take_along_axis(b_cls, np.clip(src, 0, b_cls.shape[1] - 1), 1)
    bs = np.where((src >= 0) & (src < lb[:, None]), bs, 4).astype(np.int32)
    fn = jax.jit(jss.banded_nw_score_jnp, static_argnames="amax")
    return np.asarray(fn(a_cls, bs, la, lb, dlo, bw, gp,
                         amax=a_cls.shape[1]))


def test_banded_nw_score_matches_jax_at_dyadic_penalties():
    """banded_nw_score against banded_nw_score_jnp on pairs of 20-250
    letters in bands of 1-128 lanes (not only the step's), dyadic
    penalties: bit-equal."""
    rng = np.random.default_rng(41)
    n = 48
    la = rng.integers(20, 250, n).astype(np.int32)
    lb = np.clip(la + rng.integers(-60, 61, n), 20, 250).astype(np.int32)
    lo, hi = np.minimum(la, lb), np.maximum(la, lb)
    dlo = np.maximum(lo - rng.integers(0, 50, n), 1).astype(np.int32)
    dhi = np.minimum(hi + rng.integers(0, 50, n), la + lb - 1)
    bw = np.minimum(dhi - dlo + 1, 128).astype(np.int32)
    bw = np.maximum(bw, hi - dlo + 1).astype(np.int32)
    a_cls = rng.integers(0, 4, (n, 256)).astype(np.int32)
    b_cls = a_cls.copy()
    b_cls = np.where(rng.random((n, 256)) < 0.15,
                     rng.integers(0, 4, (n, 256)), b_cls).astype(np.int32)
    a_cls[np.arange(256)[None, :] >= la[:, None]] = 4
    b_cls[np.arange(256)[None, :] >= lb[:, None]] = 4
    gp = gap_params(nucleo_params(*DYADIC))[:12].numpy()
    js = _jax_score(a_cls, b_cls, la, lb, dlo, bw, gp)
    ps = pss.banded_nw_score(*(torch.from_numpy(x) for x in (
        a_cls.astype(np.uint8), b_cls.astype(np.uint8), la, lb, dlo, bw,
        gp)))
    assert bw.max() > 126 and bw.min() < 40
    np.testing.assert_array_equal(_bits(js), _bits(ps.numpy()))


def _both_on_pairs(queries, targets, pen):
    jargs = _pair_args(queries, targets, pen=pen)
    jout = _jax_step(jargs)
    pargs = list(_port_args_from_jax(jargs))
    pargs[2] = torch.from_numpy(pss.letter_rows(queries, 256))
    pout = pss.make_search_step(256, CPU)(*pargs)
    np.testing.assert_array_equal(jout[1], pout[1].numpy())
    return jout[2], pout[2].numpy(), _oracle_scores(queries, targets, pen)


def test_non_dyadic_port_equals_oracle_where_jax_does_not():
    """init4(-10.3, -1.1, -0.7, -0.4): the JAX step's doubling scans add
    s * ext where the oracle adds ext once a cell, and 12 of these 24
    scores differ from the oracle's; the port's equal it on every pair."""
    qs, ts = _pairs(61, 12, 200, 150)
    q2, t2 = _pairs(62, 12, 150, 200)
    js, ps, orc = _both_on_pairs(qs + q2, ts + t2, NON_DYADIC)
    np.testing.assert_array_equal(_bits(ps), _bits(orc))
    assert int((_bits(js) != _bits(orc)).sum()) == 12


@pytest.mark.parametrize("lb,bw", [(106, 127), (105, 128)])
def test_bands_of_127_and_128_lanes_equal_jax_and_oracle(lb, bw):
    """|la - lb| = 94, 95: bands wider than the row-sweep kernel's 126
    lanes, scored by the hole DP's kernels; the JAX step's 128 lanes hold
    them, and all three agree bit for bit."""
    qs, ts = _pairs(70 + lb, 4, 200, lb)
    q2, t2 = _pairs(80 + lb, 4, lb, 200)
    la_, lb_ = torch.tensor([200, lb]), torch.tensor([lb, 200])
    assert pss.step_band(la_, lb_)[1].tolist() == [bw, bw]
    js, ps, orc = _both_on_pairs(qs + q2, ts + t2, DYADIC)
    np.testing.assert_array_equal(_bits(ps), _bits(orc))
    np.testing.assert_array_equal(_bits(js), _bits(orc))


def test_bands_over_128_lanes_port_equals_oracle_where_jax_does_not():
    """|la - lb| = 140 (band 173): the JAX step's band is cut to 128 lanes
    and its final cell lies past them, so it returns its NEG sentinel
    -9e9 (la > lb) or NaN (la < lb); the port scores the full band, equal
    to the oracle."""
    qs, ts = _pairs(91, 4, 200, 60)
    q2, t2 = _pairs(92, 4, 60, 200)
    js, ps, orc = _both_on_pairs(qs + q2, ts + t2, DYADIC)
    np.testing.assert_array_equal(_bits(ps), _bits(orc))
    assert (js[:4] == NEG).all() and np.isnan(js[4:]).all()
    assert (orc > -200).all()


def test_n_inside_query_port_equals_oracle_where_jax_does_not():
    """Queries with 3 Ns: the JAX step counts la as the letters below class
    4 and so aligns a query shortened by 3 letters; the port counts every
    letter, equal to the oracle (and to the JAX step without the Ns)."""
    qs, ts = _pairs(101, 6, 200, 190, n_n=3)
    js, ps, orc = _both_on_pairs(qs, ts, DYADIC)
    np.testing.assert_array_equal(_bits(ps), _bits(orc))
    assert (_bits(js) != _bits(orc)).all()
    qs, ts = _pairs(101, 6, 200, 190)
    js, ps, orc = _both_on_pairs(qs, ts, DYADIC)
    np.testing.assert_array_equal(_bits(js), _bits(ps))


# -- SINTAX's boot counts ------------------------------------------------

@pytest.mark.parametrize("shape", [None, "2x4", "1x2"])
def test_sintax_boot_counts_match_jax(shape, monkeypatch):
    """(Q, BOOTS, M) sampled words against a (V, T) 0/1 incidence with 37
    targets (not a multiple of the "db" axis): the port's counts equal the
    JAX function's, with and without a mesh, in chunks of queries."""
    rng = np.random.default_rng(17)
    inc = (rng.random((64, 37)) < 0.3).astype(np.float32)
    words = rng.integers(0, 64, (5, 7, 9)).astype(np.int32)
    if shape is None:
        jmesh, pmesh = None, None
    else:
        n_data, n_db = (int(x) for x in shape.split("x"))
        jmesh = JaxMesh(np.array(jax.devices()[:n_data * n_db]).reshape(
            n_data, n_db), ("data", "db"))
        pmesh = single_mesh(CPU, n_db, n_data)
    ref = jss.sintax_boot_counts(inc, words, mesh=jmesh)
    monkeypatch.setattr(pss, "BOOT_CHUNK_BYTES", 7 * 37 * 2)
    got = pss.sintax_boot_counts(torch.from_numpy(inc.astype(np.int8)),
                                 words, mesh=pmesh, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (5, 7, 37)
    np.testing.assert_array_equal(ref, got.numpy())


# -- the sharded hole DP -------------------------------------------------

def _dp_pairs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        la = int(rng.integers(30, 160))
        a = rng.integers(0, 4, la)
        b = np.concatenate([a[:la // 2], rng.integers(0, 4, 3), a[la // 2:]])
        b[rng.integers(0, len(b), 6)] = rng.integers(0, 4, 6)
        out.append((ACGT[a], ACGT[b]))
    return out


@pytest.mark.parametrize("n_entries,pen", [(4, DYADIC), (3, NON_DYADIC),
                                           (8, DYADIC)])
def test_align_sharded_matches_align_and_native(n_entries, pen):
    """Pairs split over a "data" axis of n entries (13 pairs: blocks of
    unequal size, and empty ones at 8): scores bit-equal and paths equal
    to align() and to the host C kernel nw_band."""
    ap = nucleo_params(*pen)
    pairs = _dp_pairs(n_entries, 13)
    aligner = TorchWaveAligner(ap, CPU)
    s1, p1 = aligner.align(pairs, 12)
    s2, p2 = aligner.align_sharded(pairs, 12,
                                   Mesh([[CPU]] * n_entries))
    s3, p3 = native_nw_band(pairs, 12, ap)
    np.testing.assert_array_equal(_bits(s1), _bits(s2))
    np.testing.assert_array_equal(_bits(s3), _bits(s2))
    assert p1 == p2 == p3


def test_align_sharded_along_db_axis():
    """axis="db" takes the mesh's row of entries."""
    ap = nucleo_params(*DYADIC)
    pairs = _dp_pairs(5, 6)
    aligner = TorchWaveAligner(ap, CPU)
    s1, p1 = aligner.align(pairs, 8)
    s2, p2 = aligner.align_sharded(pairs, 8, single_mesh(CPU, 4, 1),
                                   axis="db")
    np.testing.assert_array_equal(_bits(s1), _bits(s2))
    assert p1 == p2


# -- the entry -----------------------------------------------------------

def test_entry_matches_jax_entry():
    """entry(): the step and its arguments on the device asked for; its
    outputs equal the JAX entry's jitted step's."""
    step, args = port_entry.entry(CPU)
    assert all(a.device == CPU for a in args)
    fn, jargs = jax_entry.entry()
    _assert_same([np.asarray(x) for x in fn(*jargs)], step(*args))


def test_dryrun_multichip_on_cpu(capsys):
    """dryrun_multichip(8) on a CPU mesh of 2 x 4: every leg passes, and
    the mesh built is printed."""
    port_entry.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "'data': 2, 'db': 4" in out and "dryrun_multichip OK" in out


def test_mesh_shape_matches_jax_factoring():
    assert [port_entry.mesh_shape(n) for n in (1, 2, 4, 6, 8, 16)] == \
        [(1, 1), (1, 2), (2, 2), (3, 2), (2, 4), (2, 8)]
