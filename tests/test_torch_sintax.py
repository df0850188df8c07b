"""SINTAX's bootstraps in usearch12_tpu_torch on the CPU (the kernels'
plain PyTorch versions) against the JAX package: the boot step against
BootEngine.run_chunk (jax on the CPU), classify_window against both
packages' host classifiers, and -tabbedout bytes of both command lines.
Each package builds its classifier from the same files with its own
code."""

import json
import os

import numpy as np
import pytest
import torch

import usearch12_tpu.cli as jax_cli
import usearch12_tpu_torch.cli as port_cli
import usearch12_tpu.amplicon.sintax as jax_sintax
import usearch12_tpu.commands as jax_commands
import usearch12_tpu.config as jax_config
import usearch12_tpu.index.udb as jax_udb
import usearch12_tpu_torch.commands as port_commands
import usearch12_tpu_torch.config as port_config
import usearch12_tpu_torch.index.udb as port_udb
from tests.test_sintax_device import _gen
from usearch12_tpu.amplicon.sintax_device import (BootEngine,
                                                  SintaxDeviceClassifier)
from usearch12_tpu_torch.amplicon import sintax as port_sintax
from usearch12_tpu_torch.amplicon.sintax_device import (
    SintaxTorchClassifier, TorchBootEngine)
from usearch12_tpu_torch.ops import sintax_boot as sb

CPU = torch.device("cpu")


def _csr(rng, v, t, max_size=12):
    sizes = rng.integers(0, max_size, v)
    posts = [np.sort(rng.choice(t, min(int(s), t), replace=False))
             for s in sizes]
    sizes = np.array([len(p) for p in posts], np.int64)
    return sizes, np.concatenate(posts).astype(np.int32)


# (case, T, m per job (None: 1..24 per job), mmax, live jobs of the chunk)
CASES = {
    "default_m32": (40, 32, 32, 8),
    "m_over_127": (40, 200, 256, 8),
    "m_over_2048": (40, 20000, 32768, 8),
    "divide_mode": (40, None, 32, 8),
    "m_zero": (40, 0, 8, 8),
    "one_target": (1, 32, 32, 8),
    "padded_rows": (40, 32, 32, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_boot_step_equals_jax_run_chunk(case):
    """Winners and tops of one chunk equal the JAX step's, as integers."""
    t, m_val, mmax, live = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    v, boots, cq, uwmax = 64, 20, 8, 16
    sizes, posts = _csr(rng, v, t)
    words = np.zeros((cq, uwmax), np.int32)
    nuw = np.ones(cq, np.int32)              # padding as the JAX host pads
    m = np.ones(cq, np.int32)
    rr = np.zeros((cq, boots), np.uint32)
    for k in range(live):
        nuw[k] = rng.integers(8, uwmax + 1)
        words[k, :nuw[k]] = rng.choice(v, nuw[k], replace=False)
        m[k] = rng.integers(1, 25) if m_val is None else m_val
        rr[k] = rng.integers(0, 2 ** 32, boots, dtype=np.uint64)
    stream = rng.integers(0, 2 ** 32, boots * mmax,
                          dtype=np.uint64).astype(np.uint32)
    want = BootEngine(v, t, sizes, posts, boots).run_chunk(
        words, nuw, m, stream, rr)
    eng = TorchBootEngine(v, t, sizes, posts, boots, CPU)
    got = eng.run_chunk(words, nuw, m, stream, rr)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if m_val == 0:
        assert not got[1].any()
    if t == 1:
        assert not got[0].any()


def _chunk_inputs(case):
    """One chunk of CASES[case] (the inputs test_boot_step_equals_jax_run_chunk
    makes), or "straddle": every word posts targets 20..60 of 70, so every
    boot row ties on 41 targets across tile boundaries."""
    v, boots, cq, uwmax = 64, 20, 8, 16
    if case == "straddle":
        rng = np.random.default_rng(99)
        t, m_val, mmax, live = 70, 32, 32, 8
        sizes = np.full(v, 41, np.int64)
        posts = np.tile(np.arange(20, 61, dtype=np.int32), v)
    else:
        t, m_val, mmax, live = CASES[case]
        rng = np.random.default_rng(sorted(CASES).index(case))
        sizes, posts = _csr(rng, v, t)
    words = np.zeros((cq, uwmax), np.int32)
    nuw = np.ones(cq, np.int32)
    m = np.ones(cq, np.int32)
    rr = np.zeros((cq, boots), np.uint32)
    for k in range(live):
        nuw[k] = rng.integers(8, uwmax + 1)
        words[k, :nuw[k]] = rng.choice(v, nuw[k], replace=False)
        m[k] = rng.integers(1, 25) if m_val is None else m_val
        rr[k] = rng.integers(0, 2 ** 32, boots, dtype=np.uint64)
    stream = rng.integers(0, 2 ** 32, boots * mmax,
                          dtype=np.uint64).astype(np.uint32)
    return (v, t, sizes, posts, boots), (words, nuw, m, stream, rr)


_JAX_CHUNKS = {}


def _jax_chunk(case):
    if case not in _JAX_CHUNKS:
        db, chunk = _chunk_inputs(case)
        _JAX_CHUNKS[case] = BootEngine(*db).run_chunk(*chunk)
    return _JAX_CHUNKS[case]


@pytest.mark.parametrize("tile", [1, 7, 32])
@pytest.mark.parametrize("case", list(CASES) + ["straddle"])
def test_tile_merge_equals_select_and_jax(case, tile):
    """The plain version of the card's two-stage count and select (tile
    partials merged in ascending order, the tie found in one recomputed
    tile) equals boot_select_plain over U and the JAX step."""
    db, (words, nuw, m, stream, rr) = _chunk_inputs(case)
    eng = TorchBootEngine(*db, CPU)
    up = lambda x: torch.from_numpy(x.view(np.int32))  # noqa: E731
    boots, uwmax = eng.B, words.shape[1]
    P = sb.pick_hist(up(nuw), up(m), up(stream), boots, uwmax,
                     torch.float32)
    got = sb.boot_count_select_plain(P, up(words), up(nuw), eng.w_mat,
                                     up(rr), tile)
    U = sb.boot_product(P, sb.gather_rows(eng.w_mat, up(words), up(nuw),
                                          torch.float32))
    want = sb.boot_select_plain(U, up(rr))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    jax_w, jax_t = _jax_chunk(case)
    np.testing.assert_array_equal(got[0].numpy(), jax_w)
    np.testing.assert_array_equal(got[1].numpy(), jax_t)
    if case == "straddle":
        assert set(got[0][:8].flatten().tolist()) <= set(range(20, 61))
        assert len(set(got[0][:8].flatten().tolist())) > 5


def test_incidence_is_additive_int8():
    """A target posted twice under one word counts twice (the JAX build's
    scatter-add), and the product type stays exact."""
    sizes = np.array([3, 0, 1], np.int64)
    posts = np.array([1, 1, 0, 2], np.int32)
    eng = TorchBootEngine(3, 3, sizes, posts, 4, CPU)
    assert eng.w_mat.tolist() == [[1, 2, 0], [0, 0, 0], [0, 0, 1]]
    assert eng.inc_absmax == 2
    cuda = torch.device("cuda")
    assert sb.product_dtype(cuda, 127, eng.inc_absmax) == torch.int8
    assert sb.product_dtype(cuda, 128, eng.inc_absmax) == torch.float16
    assert sb.product_dtype(cuda, 2048, eng.inc_absmax) == torch.float16
    assert sb.product_dtype(cuda, 2049, eng.inc_absmax) == torch.float16
    assert sb.product_dtype(CPU, 10, eng.inc_absmax) == torch.float32
    with pytest.raises(ValueError):
        sb.product_dtype(CPU, (1 << 23) + 1, eng.inc_absmax)


def test_split_slots_above_2048_picks():
    """Counts above 2048, which the card's float16 operand does not hold,
    split over repeated word slots (the card's route for more than 2048
    picks a boot): the parts sum to the counts, and the plain count and
    select over them equals the JAX step."""
    db, (words, nuw, m, stream, rr) = _chunk_inputs("m_over_2048")
    eng = TorchBootEngine(*db, CPU)
    up = lambda x: torch.from_numpy(x.view(np.int32))  # noqa: E731
    P = sb.pick_hist(up(nuw), up(m), up(stream), eng.B, words.shape[1],
                     torch.float32)
    assert float(P.max()) > sb.FP16_EXACT
    P16, words16, nuw16 = sb.split_slots(P, up(words), up(nuw))
    k = words16.shape[1] // words.shape[1]
    assert k >= 2 and P16.dtype == torch.float16
    assert float(P16.max()) <= sb.FP16_EXACT
    assert torch.equal(P16.float().view(*P.shape, k).sum(3), P)
    assert torch.equal(nuw16, up(nuw) * k)
    got = sb.boot_count_select_plain(P16, words16, nuw16, eng.w_mat, up(rr))
    jax_w, jax_t = _jax_chunk("m_over_2048")
    np.testing.assert_array_equal(got[0].numpy(), jax_w)
    np.testing.assert_array_equal(got[1].numpy(), jax_t)


def jax_step_hist(nuw, m, stream, boots, uwmax):
    """The JAX step's pick histogram (sintax_device.py:125-141) in numpy:
    mmax = len(stream) // boots draws a boot, draw_pos clipped to the
    stream, uint32 picks modulo max(nuw, 1), added where k < m."""
    cq = len(nuw)
    mmax = len(stream) // boots
    b_idx = np.arange(boots, dtype=np.int64)[:, None]
    k_idx = np.arange(mmax, dtype=np.int64)[None, :]
    draw_pos = np.clip(b_idx * m.astype(np.int64)[:, None, None]
                       + k_idx[None], 0, boots * mmax - 1)
    draws = stream.astype(np.uint32)[draw_pos]
    live = np.broadcast_to(k_idx[None] < m[:, None, None], draws.shape)
    pick = draws % np.maximum(nuw, 1).astype(np.uint32)[:, None, None]
    P = np.zeros((cq, boots, uwmax), np.int64)
    n_i, b_i, _ = np.broadcast_arrays(np.arange(cq)[:, None, None],
                                      b_idx[None], pick)
    np.add.at(P, (n_i[live], b_i[live], pick[live].astype(np.int64)), 1)
    return P


def hist_chunk(m_val, uwmax, short, seed=0):
    """A chunk of 6 jobs x 5 boots: nuw 0, 1, uwmax and at random, m =
    m_val (0 and 1 in two of the jobs); a stream of 5 * m_val draws, or
    a third of that (short: the later boots' positions clip), a multiple
    of the boots as the JAX step's stream is."""
    rng = np.random.default_rng(seed + m_val + uwmax + short)
    boots = 5
    nuw = np.array([0, 1, uwmax] + list(rng.integers(1, uwmax + 1, 3)),
                   np.int32)
    m = np.full(6, m_val, np.int32)
    m[4] = min(m_val, 1)
    m[5] = 0
    n = boots * max(1, max(m_val, 1) // (3 if short else 1))
    stream = rng.integers(0, 2 ** 32, n,
                          dtype=np.uint64).astype(np.uint32)
    return nuw, m, stream, boots


def hist_dtype(m_val):
    """P's type on the card for m_val picks (product_dtype's rule, with
    the float32 count of boot_step above 2048)."""
    return (torch.int8 if m_val <= sb.INT8_MAX else
            torch.float16 if m_val <= sb.FP16_EXACT else torch.float32)


@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("uwmax", [8, 8192])
@pytest.mark.parametrize("m_val", [0, 1, 127, 128, 2049])
def test_pick_hist_plain_equals_jax_step(m_val, uwmax, short):
    """pick_hist_plain in the card's type for m against the JAX step's
    histogram: nuw = 0 and 1, m = 0, a stream shorter than boots x m."""
    nuw, m, stream, boots = hist_chunk(m_val, uwmax, short)
    up = lambda x: torch.from_numpy(x.view(np.int32))  # noqa: E731
    dtype = hist_dtype(m_val)
    P = sb.pick_hist_plain(up(nuw), up(m), up(stream), boots, uwmax, dtype)
    assert P.dtype == dtype and P.shape == (6, boots, uwmax)
    want = jax_step_hist(nuw, m, stream, boots, uwmax)
    np.testing.assert_array_equal(P.to(torch.int64).numpy(), want)
    assert not want[5].any() and want[0, :, 1:].sum() == 0
    assert (want.sum(2) == np.minimum(m, len(stream) // boots)[:, None]).all()
    assert torch.equal(sb.pick_hist(up(nuw), up(m), up(stream), boots, uwmax,
                                    dtype), P)


def test_wrappers_refuse_bad_chunks():
    """The kernels index unchecked: the wrappers check first."""
    nuw = torch.tensor([20], dtype=torch.int32)
    m = torch.tensor([4], dtype=torch.int32)
    stream = torch.zeros(40, dtype=torch.int32)
    with pytest.raises(ValueError, match="nuw"):
        sb.pick_hist(nuw, m, stream, 10, 16, torch.float32)
    with pytest.raises(ValueError, match="stream"):
        sb.pick_hist(nuw, m, stream[:5], 10, 32, torch.float32)
    with pytest.raises(ValueError, match="m outside"):   # int8 wraps at 128
        sb.pick_hist(nuw, torch.tensor([128], dtype=torch.int32), stream,
                     10, 32, torch.int8)
    with pytest.raises(ValueError, match="m outside"):
        sb.pick_hist(nuw, torch.tensor([-1], dtype=torch.int32), stream,
                     10, 32, torch.float32)
    i32 = torch.int32
    counts = (torch.zeros((2, 3, 8)), torch.zeros((2, 8), dtype=i32),
              torch.full((2,), 8, dtype=i32),
              torch.zeros((5, 7), dtype=torch.int8))
    with pytest.raises(ValueError):          # rr of 4 boots, P of 3
        sb.boot_count_select(*counts, torch.zeros((2, 4), dtype=i32))


def _classifier(pkg, dbf):
    """A host SintaxClassifier of the DB, built by one package (the JAX
    package or the port) from the file with its own code."""
    sintax, commands, config, udb = {
        "jax": (jax_sintax, jax_commands, jax_config, jax_udb),
        "port": (port_sintax, port_commands, port_config, port_udb)}[pkg]
    config.options().set("randseed", "1")
    db, index = commands.load_db(dbf)
    if index is None:
        index = udb.UDBIndex.from_seqdb(db)
    return sintax.SintaxClassifier(db, index, sintax.GlobalRand(1))


@pytest.mark.parametrize("both", [True, False])
def test_classify_window_equals_host(tmp_path, both):
    dbf, qf = _gen(tmp_path, n_db=150, n_q=40)
    from usearch12_tpu.io.fastx import read_fastx
    seqs = [s for _, s, _ in read_fastx(qf)]
    # revcomp of a few queries, so that the minus strand wins some votes
    from usearch12_tpu.alpha import revcomp
    seqs = [revcomp(s) if k % 3 == 0 else s for k, s in enumerate(seqs)]
    want = _classifier("jax", dbf).classify_window(seqs, both)
    assert _classifier("port", dbf).classify_window(seqs, both) == want
    got = SintaxTorchClassifier(_classifier("port", dbf),
                                CPU).classify_window(seqs, both)
    assert got == want
    assert {r[0] for r in got} == ({"+", "-"} if both else {"+"})


def test_classifier_on_a_converted_db(tmp_path):
    """A DB the JAX package loaded reaches the port through state.py; the
    port's index and classifier on it classify as the JAX package's."""
    from usearch12_tpu_torch import state
    dbf, qf = _gen(tmp_path, n_db=60, n_q=16)
    jcls = _classifier("jax", dbf)
    db = state.seq_db(jcls.db)
    assert db.labels == jcls.db.labels and db.get_is_nucleo()
    assert all(np.array_equal(x, y) for x, y in zip(db.seqs, jcls.db.seqs))
    cls = port_sintax.SintaxClassifier(db, port_udb.UDBIndex.from_seqdb(db),
                                       port_sintax.GlobalRand(1))
    from usearch12_tpu.io.fastx import read_fastx
    seqs = [s for _, s, _ in read_fastx(qf)]
    assert cls.classify_window(seqs, True) == \
        jcls.classify_window(seqs, True)


def test_ineligible_gives_the_reason_usable_gives(tmp_path, monkeypatch):
    """The port's rules agree with the JAX SintaxDeviceClassifier.usable()
    under the same incidence limit."""
    dbf, _ = _gen(tmp_path, n_db=20, n_q=1)
    cls, jcls = _classifier("port", dbf), _classifier("jax", dbf)
    assert port_sintax.ineligible(cls) is None
    assert SintaxTorchClassifier.usable(cls)
    assert SintaxDeviceClassifier.usable(jcls)
    assert port_sintax.MAX_INCIDENCE_BYTES == \
        SintaxDeviceClassifier.MAX_INCIDENCE_BYTES
    limit = cls.index.params.slot_count * 19
    monkeypatch.setattr(port_sintax, "MAX_INCIDENCE_BYTES", limit)
    monkeypatch.setattr(SintaxDeviceClassifier, "MAX_INCIDENCE_BYTES", limit)
    assert port_sintax.ineligible(cls).startswith("incidence of")
    assert not SintaxTorchClassifier.usable(cls)
    assert not SintaxDeviceClassifier.usable(jcls)
    port_config.options().set("self", True)
    assert port_sintax.ineligible(cls) == "-self"


@pytest.fixture(scope="module")
def fixture_db(tmp_path_factory):
    """tests/test_sintax_device.py's fixture: 300 targets, 120 queries."""
    return _gen(tmp_path_factory.mktemp("sintax"))


def _tabbed(cli, d, name, args, **kw):
    out = str(d / name)
    assert cli.main(args + ["-tabbedout", out], **kw) == 0
    return open(out, "rb").read()


@pytest.mark.parametrize("strand,extra", [("both", []), ("plus", []),
                                          ("plus", ["-boot_subset", "/8"])])
def test_tabbedout_equals_jax(fixture_db, tmp_path, monkeypatch, strand,
                              extra):
    """The port with -sintax_device writes the JAX host path's bytes and
    the JAX device path's."""
    dbf, qf = fixture_db
    base = ["-sintax", qf, "-db", dbf, "-strand", strand, "-quiet",
            "-randseed", "1"] + extra
    stats = tmp_path / "stats.jsonl"
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    sb.pick_hist.launches = sb.boot_count_select.launches = 0
    port = _tabbed(port_cli, tmp_path, "port", base + ["-sintax_device"],
                   device="cpu")
    assert (sb.pick_hist.launches, sb.boot_count_select.launches) == (0, 0)
    rec = json.loads(stats.read_text())
    assert rec == {"cmd": "sintax", "device": True,
                   "reason": "-sintax_device", "queries": 120,
                   "targets": 300}
    host = _tabbed(jax_cli, tmp_path, "host", base)
    assert port == host and port.count(b"\n") == 120
    assert port == _tabbed(jax_cli, tmp_path, "jax_dev",
                           base + ["-sintax_device"])


def _stats_of(tmp_path, monkeypatch, args):
    stats = tmp_path / "stats.jsonl"
    stats.unlink(missing_ok=True)
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    _tabbed(port_cli, tmp_path, "out", args, device="cpu")
    return json.loads(stats.read_text())


def test_device_choice(fixture_db, tmp_path, monkeypatch):
    """Auto takes the card at AUTO_MIN_TARGETS targets; the flags force
    either way; every choice is recorded with its reason."""
    dbf, qf = fixture_db
    base = ["-sintax", qf, "-db", dbf, "-strand", "plus", "-quiet"]
    host = _tabbed(jax_cli, tmp_path, "host", base)
    rec = _stats_of(tmp_path, monkeypatch, base)
    assert (rec["device"], rec["reason"]) == (
        False, f"auto: 300 < {port_sintax.AUTO_MIN_TARGETS} targets")
    monkeypatch.setattr(port_sintax, "AUTO_MIN_TARGETS", 300)
    rec = _stats_of(tmp_path, monkeypatch, base)
    assert (rec["device"], rec["reason"]) == (True,
                                              "auto: 300 >= 300 targets")
    assert (tmp_path / "out").read_bytes() == host
    rec = _stats_of(tmp_path, monkeypatch, base + ["-no_sintax_device"])
    assert (rec["device"], rec["reason"]) == (False, "-no_sintax_device")
    assert (tmp_path / "out").read_bytes() == host


def test_no_fallback_on_device_error(fixture_db, tmp_path, monkeypatch):
    """A failure on the device path raises, whether the card was forced
    or chosen by the auto gate."""
    dbf, qf = fixture_db
    base = ["-sintax", qf, "-db", dbf, "-strand", "plus", "-quiet",
            "-tabbedout", str(tmp_path / "out")]

    def broken(*_a, **_k):
        raise RuntimeError("sintax_boot_count_select: CUDA error 700")

    monkeypatch.setattr(TorchBootEngine, "run_chunk", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        port_cli.main(base + ["-sintax_device"], device="cpu")
    monkeypatch.setattr(port_sintax, "AUTO_MIN_TARGETS", 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        port_cli.main(base, device="cpu")


def test_card_is_needed_only_when_chosen(fixture_db, tmp_path, monkeypatch):
    dbf, qf = fixture_db
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["-sintax", qf, "-db", dbf, "-strand", "plus", "-quiet",
            "-tabbedout", str(tmp_path / "out")]
    assert port_cli.main(base) == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(base + ["-sintax_device"])
    assert os.path.getsize(tmp_path / "out") > 0


def test_per_query_path_equals_jax(fixture_db, tmp_path, monkeypatch):
    """Without a window classifier (no native library, or a hashed word
    index) both sintax commands classify one query at a time, with equal bytes."""
    dbf, qf = fixture_db
    for sintax in (jax_sintax, port_sintax):
        monkeypatch.setattr(sintax.SintaxClassifier, "classify_window",
                            lambda self, seqs, both: None)
    base = ["-sintax", qf, "-db", dbf, "-strand", "both", "-quiet"]
    port = _tabbed(port_cli, tmp_path, "port", base, device="cpu")
    assert port == _tabbed(jax_cli, tmp_path, "host", base)
    assert port.count(b"\n") == 120
