"""usearch12_tpu_torch's CUDA kernels against their plain PyTorch versions
and the oracle, on the card.  Marked `cuda`; they skip where no card is
present.  Run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from usearch12_tpu.align.oracle import banded_nw_main_diag
from usearch12_tpu_torch import device_server as ds
from usearch12_tpu_torch.ops import wavefront_nw as wnw
from usearch12_tpu_torch.ops import wavefront_trace as wtr

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _pairs(seed, n, lmin, lmax):
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for _ in range(n):
        la = int(rng.integers(lmin, lmax))
        lb = max(1, la + int(rng.integers(-20, 21)))
        a, b = rng.integers(0, 4, la), rng.integers(0, 4, lb)
        m = min(la, lb)
        b[:m] = a[:m]
        b[rng.integers(0, m, max(1, m // 10))] = rng.integers(
            0, 4, max(1, m // 10))
        out.append((conv[a], conv[b]))
    return out


def _bit_equal(x, y):
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


@pytest.mark.parametrize("radius,cls", [(16, 0), (120, 5), (7, 15)])
def test_kernels_match_plain_versions(card, radius, cls):
    ap = wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4).hole_params(
        bool(cls & 1), bool(cls & 2), bool(cls & 4), bool(cls & 8))
    pairs = _pairs(radius + cls, 64, 1, 400)
    w = wnw.pack_launch(pairs, *wnw.pair_geometry(pairs, radius), card)
    gp = wnw.gap_params(ap).to(card)
    mm = wnw.match_mismatch(ap)
    n0 = wnw.wavefront_fwd.launches
    fwd = wnw.wavefront_fwd(*w, gp, *mm)
    assert wnw.wavefront_fwd.launches == n0 + 1
    plain = wnw.wavefront_fwd_plain(*w, gp, *mm)
    for x, y in zip(fwd, plain):
        assert _bit_equal(x, y)
    args = (fwd[0], w.tb_off, fwd[1], fwd[2], w.la, w.lb, w.dlo, w.bw, gp)
    tr = wtr.wavefront_trace(*args)
    torch.cuda.synchronize()
    for x, y in zip(tr, wtr.wavefront_trace_plain(*args, tr[1].shape[1])):
        assert _bit_equal(x, y)
    paths = wtr.decode_ops(tr[1].cpu().numpy(), tr[2].cpu().numpy())
    for k in range(0, len(pairs), 8):
        s_o, p_o = banded_nw_main_diag(*pairs[k], radius, ap)
        assert np.float32(s_o) == tr[0][k].item() and p_o == paths[k]


@pytest.mark.parametrize("radius", [8, 31, 32, 120, 600])
def test_forward_kernel_matches_plain_at_every_band(card, radius):
    """Blocks of one warp (bands up to 63) to 19 warps (band 1,201), the
    pairs of a launch of many lengths and bands."""
    ap = wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4)
    pairs = _pairs(radius, 45, 1, 2 * radius + 300)
    w = wnw.pack_launch(pairs, *wnw.pair_geometry(pairs, radius), card)
    gp = wnw.gap_params(ap).to(card)
    mm = wnw.match_mismatch(ap)
    got = wnw.wavefront_fwd(*w, gp, *mm)
    plain = wnw.wavefront_fwd_plain(*w, gp, *mm)
    torch.cuda.synchronize()
    for x, y in zip(got, plain):
        assert _bit_equal(x, y)


def test_aligner_on_card_matches_cpu(card):
    ap = wnw.nucleo_params(-10.0, -1.0, -0.5, -0.5)
    pairs = _pairs(3, 200, 100, 900)
    s_gpu, p_gpu = wnw.TorchWaveAligner(ap, card, tb_budget=1 << 20).align(
        pairs, 32)
    s_cpu, p_cpu = wnw.TorchWaveAligner(ap, torch.device("cpu")).align(
        pairs, 32)
    assert np.array_equal(s_gpu, s_cpu) and p_gpu == p_cpu


@pytest.mark.parametrize("radius,pen", [(16, (-10.0, -1.0, -0.5, -0.5)),
                                        (62, (-10.3, -1.1, -0.7, -0.4))])
def test_banded_nw_kernels_match_plain_versions(card, radius, pen):
    from usearch12_tpu_torch.ops import banded_nw as bn
    ap = wnw.nucleo_params(*pen)
    rng = np.random.default_rng(radius)
    conv = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(96):
        la = int(rng.integers(1, 300))
        a = rng.integers(0, 4, la)
        b = a.copy()
        b[rng.random(la) < 0.1] = rng.integers(0, 4)
        if radius == 16 and la > 8:
            b = b[:la - int(rng.integers(0, 8))]
        pairs.append((conv[a], conv[b]))
    batch = bn.pack_pairs(pairs, True, radius)
    args = tuple(torch.from_numpy(x).to(card) for x in (
        batch.a_let, batch.b_let, batch.la, batch.lb, batch.dlo, batch.bw))
    gp = wnw.gap_params(ap).to(card)
    mm = wnw.match_mismatch(ap)
    n0 = (bn.banded_nw_fwd.launches, bn.banded_nw_chase.launches)
    for with_tb in (True, False):
        fwd = bn.banded_nw_fwd(*args, gp, *mm, with_tb)
        plain = bn.banded_nw_fwd_plain(*args, gp, *mm, fwd[1].shape[1],
                                       with_tb)
        for x, y in zip(fwd, plain):
            assert (x is None and y is None) or _bit_equal(x, y)
        ch = bn.banded_nw_chase(fwd[0], fwd[1], fwd[2], *args[2:], gp)
        stride = (int((batch.la + batch.lb).max()) + 3) // 4
        ch_plain = bn.banded_nw_chase_plain(fwd[0], fwd[1], fwd[2],
                                            *args[2:], gp, stride)
        torch.cuda.synchronize()
        for x, y in zip(ch, ch_plain):
            assert (x is None and y is None) or _bit_equal(x, y)
    assert (bn.banded_nw_fwd.launches, bn.banded_nw_chase.launches) == \
        (n0[0] + 2, n0[1] + 2)
    s, p = bn.BandedNWDevice(ap, card).align_device(pairs, radius)
    for k in range(0, len(pairs), 8):
        s_o, p_o = banded_nw_main_diag(*pairs[k], radius, ap)
        assert np.float32(s_o) == s[k] and p_o == p[k]


@pytest.mark.parametrize("m_val,mmax,t,dtype", [
    (32, 32, 500, torch.int8), (200, 256, 500, torch.float16),
    (0, 8, 300, torch.int8), (32, 32, 1, torch.int8)])
def test_sintax_kernels_match_plain_versions(card, m_val, mmax, t, dtype):
    """sintax_pick_hist and the fused count-and-select kernel against
    their plain versions (T = 1, T not a multiple of the tile, m > 127 in
    float16, m = 0 where every target ties), and the engine on the card
    against the engine on the CPU."""
    from usearch12_tpu_torch.amplicon.sintax_device import TorchBootEngine
    from usearch12_tpu_torch.ops import sintax_boot as sb
    rng = np.random.default_rng(m_val + t)
    cq, boots, uwmax, v = 16, 20, 32, 256
    sizes = rng.integers(0, 6, v)
    posts = np.concatenate([rng.choice(t, min(int(s), t), replace=False)
                            for s in sizes]).astype(np.int32)
    sizes = np.array([min(int(s), t) for s in sizes])
    nuw = rng.integers(8, uwmax + 1, cq).astype(np.int32)
    nuw[0] = 0
    words = rng.integers(-4, v + 4, (cq, uwmax)).astype(np.int32)
    m = np.full(cq, m_val, np.int32)
    stream = rng.integers(0, 2 ** 32, boots * mmax,
                          dtype=np.uint64).astype(np.uint32)
    rr = rng.integers(0, 2 ** 32, (cq, boots),
                      dtype=np.uint64).astype(np.uint32)
    up = lambda x: torch.from_numpy(x.view(np.int32)).to(card)  # noqa: E731
    n0 = (sb.pick_hist.launches, sb.boot_count_select.launches)
    eng = TorchBootEngine(v, t, sizes, posts, boots, card)
    assert sb.product_dtype(card, m_val, eng.inc_absmax) == dtype
    P = sb.pick_hist(up(nuw), up(m), up(stream), boots, uwmax, dtype)
    assert torch.equal(P, sb.pick_hist_plain(up(nuw), up(m), up(stream),
                                             boots, uwmax, dtype))
    args = (P, up(words), up(nuw), eng.w_mat, up(rr))
    got = sb.boot_count_select(*args)
    want = sb.boot_count_select_plain(*args)
    U = sb.boot_product(P.float(), sb.gather_rows(eng.w_mat, up(words),
                                                  up(nuw), torch.float32))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(torch.equal(x, y)
               for x, y in zip(got, sb.boot_select_plain(U, up(rr))))
    assert (sb.pick_hist.launches, sb.boot_count_select.launches) == \
        (n0[0] + 1, n0[1] + 1)
    cpu = TorchBootEngine(v, t, sizes, posts, boots, torch.device("cpu"))
    w_cpu, t_cpu = cpu.run_chunk(words, nuw, m, stream, rr)
    w_card, t_card = eng.run_chunk(words, nuw, m, stream, rr)
    assert np.array_equal(w_cpu, w_card) and np.array_equal(t_cpu, t_card)


def test_sintax_boot_step_above_2048_picks(card):
    """More than 2048 picks a boot on the card: counts in float32, split
    into float16 parts over repeated slots, equal to the engine on the
    CPU."""
    from usearch12_tpu_torch.amplicon.sintax_device import TorchBootEngine
    from usearch12_tpu_torch.ops import sintax_boot as sb
    rng = np.random.default_rng(2049)
    cq, boots, uwmax, v, t = 16, 20, 16, 64, 500
    sizes = rng.integers(0, 40, v)
    posts = np.concatenate([rng.choice(t, int(s), replace=False)
                            for s in sizes]).astype(np.int32)
    nuw = rng.integers(8, 12, cq).astype(np.int32)
    words = np.stack([rng.choice(v, uwmax, replace=False)
                      for _ in range(cq)]).astype(np.int32)
    m = np.full(cq, 20000, np.int32)
    stream = rng.integers(0, 2 ** 32, boots * 32768,
                          dtype=np.uint64).astype(np.uint32)
    rr = rng.integers(0, 2 ** 32, (cq, boots),
                      dtype=np.uint64).astype(np.uint32)
    n0 = sb.boot_count_select.launches
    card_eng = TorchBootEngine(v, t, sizes, posts, boots, card)
    w_card, t_card = card_eng.run_chunk(words, nuw, m, stream, rr)
    assert sb.boot_count_select.launches == n0 + 1
    cpu = TorchBootEngine(v, t, sizes, posts, boots, torch.device("cpu"))
    w_cpu, t_cpu = cpu.run_chunk(words, nuw, m, stream, rr)
    assert np.array_equal(w_cpu, w_card) and np.array_equal(t_cpu, t_card)
    assert t_cpu.max() > sb.FP16_EXACT


def test_sintax_resident_on_the_card_writes_the_commands_bytes(card,
                                                               tmp_path):
    """SintaxRun with its incidence on the card: each call writes the bytes
    of a fresh sintax command, on the host path and on the card, with one
    launch of each boot kernel a chunk."""
    # by its basename, as pytest imports the test files of this directory
    from test_torch_sintax_resident import _argv, _command, _data, _resident
    db, q1, q2 = _data(tmp_path, 5)
    argv = _argv(db, "-sintax_device")
    got, run = _resident(argv, [q1, q2, q1], device=card)
    assert run.on_card and run.dev_cls._engine.device == card
    host = [_command(tmp_path, q, _argv(db, "-no_sintax_device"))
            for q in (q1, q2)]
    assert got == [host[0], host[1], host[0]]
    assert _command(tmp_path, q1, argv, device=card) == host[0]
    st = run.dev_stats
    assert st["sintax_launches"] == 2 * st["sintax_chunks"] > 0
    # untraced, the card's chunks make no CUDA events
    assert "sintax_boot_device_n" not in st


def _trace_both_variants(card, pairs, radius, ap):
    """Both wavefront_trace kernels on pairs, bit-equal to the plain
    version; returns the scores and paths."""
    w = wnw.pack_launch(pairs, *wnw.pair_geometry(pairs, radius), card)
    gp = wnw.gap_params(ap).to(card)
    tb, mlast, dlb = wnw.wavefront_fwd(*w, gp, *wnw.match_mismatch(ap))
    args = (tb, w.tb_off, mlast, dlb, w.la, w.lb, w.dlo, w.bw, gp)
    outs = [wtr.wavefront_trace(*args, warp=x) for x in (True, False)]
    plain = wtr.wavefront_trace_plain(*args, outs[0][1].shape[1])
    torch.cuda.synchronize()
    for out in outs:
        for x, y in zip(out, plain):
            assert _bit_equal(x, y)
    return outs[0][0].cpu().numpy(), wtr.decode_ops(
        outs[0][1].cpu().numpy(), outs[0][2].cpu().numpy())


def test_trace_kernels_at_the_widest_band(card):
    """Band 2047 (BW_MAX; radius 1015 with |la - lb| = 16, the widest
    radius at which la != lb still fits): the warp kernel's largest
    windows (15 anti-diagonals of 512 bytes) and its band-edge cells; and
    short lopsided pairs whose band (la + lb - 1 diagonals) reaches both
    edges of the matrix."""
    ap = wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4)
    rng = np.random.default_rng(11)
    conv = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k in range(10):
        la = int(rng.integers(1500, 4500)) if k < 6 else int(
            rng.integers(900, 1500))
        lb = la + (16 if k % 2 else -16) if k < 6 else 2048 - la
        a = rng.integers(0, 4, la)
        b = np.resize(a, lb)
        b[rng.random(lb) < 0.15] = rng.integers(0, 4)
        pairs.append((conv[a], conv[b]))
    w_bw = wnw.pair_geometry(pairs, 1015)[3]
    assert w_bw.max() == wnw.BW_MAX
    s, p = _trace_both_variants(card, pairs, 1015, ap)
    for k in (0, 7):
        s_o, p_o = banded_nw_main_diag(*pairs[k], 1015, ap)
        assert np.float32(s_o) == s[k] and p_o == p[k]


@pytest.mark.parametrize("long_side", ["a", "b"])
def test_trace_kernels_on_lopsided_pairs(card, long_side):
    """la >> lb and lb >> la: paths that run along the band edge
    (k == -1) or down the j == lb column, and that start in state I."""
    ap = wnw.nucleo_params(-10.0, -1.0, -0.5, -0.5)
    rng = np.random.default_rng(5)
    conv = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(40):
        n_long, n_short = int(rng.integers(300, 1200)), int(
            rng.integers(1, 60))
        a, b = conv[rng.integers(0, 4, n_long)], conv[rng.integers(
            0, 4, n_short)]
        pairs.append((a, b) if long_side == "a" else (b, a))
    s, p = _trace_both_variants(card, pairs, 600, ap)
    for k in range(0, 40, 10):
        s_o, p_o = banded_nw_main_diag(*pairs[k], 600, ap)
        assert np.float32(s_o) == s[k] and p_o == p[k]


def _band_pairs(rng, n, bw):
    """n (a, b, dlo, dhi) pairs of band exactly bw, la > lb, la < lb and
    la == lb in turns, of 1 to 300 letters (so amax passes most la)."""
    conv = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for k in range(n):
        la = int(rng.integers(bw, max(bw + 1, 300)))
        d = 0 if bw == 1 else int(rng.integers(1, min(bw, 12)))
        lb = max(1, la + (d, -d, 0)[k % 3])
        dlo = int(rng.integers(max(1, max(la, lb) - bw + 1), min(la, lb) + 1))
        a = rng.integers(0, 4, la)
        b = np.resize(a, lb).copy()
        flip = rng.random(lb) < 0.12
        b[flip] = rng.integers(0, 5, int(flip.sum()))
        pairs.append((conv[a], conv[b], dlo, dlo + bw - 1))
    return pairs


@pytest.mark.parametrize("bw", [1, 16, 32, 33, 64, 120, 121, 126])
def test_banded_nw_fwd_every_cells(card, bw):
    """The forward kernel through its wrapper at bands either side of the
    width where it changes from 6 cells a part to 4, pairs of several la
    in one warp and a count of pairs that leaves the last warp part
    empty, bit-equal to the plain version."""
    from usearch12_tpu_torch import _build
    from usearch12_tpu_torch.ops import banded_nw as bn
    ap = wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4)
    pairs = _band_pairs(np.random.default_rng(bw), 203, bw)
    batch = bn.pack_pairs(pairs, True, 0)
    args = tuple(torch.from_numpy(x).to(card) for x in (
        batch.a_let, batch.b_let, batch.la, batch.lb, batch.dlo, batch.bw))
    gp = wnw.gap_params(ap).to(card)
    mm = wnw.match_mismatch(ap)
    plain = bn.banded_nw_fwd_plain(*args, gp, *mm, bw)
    assert _build.load_library().banded_nw_fwd_cells(bw) == (
        4 if bw > 120 else 6)
    n0 = bn.banded_nw_fwd.launches
    got = bn.banded_nw_fwd(*args, gp, *mm)
    assert bn.banded_nw_fwd.launches == n0 + 1
    torch.cuda.synchronize()
    assert all(_bit_equal(x, y) for x, y in zip(got, plain))


def _assert_chase_matches_plain(card, pairs, radius, ap):
    """banded_nw_chase's kernel through its wrapper, with and without the
    traceback, bit-equal to banded_nw_chase_plain on the forward kernel's
    outputs; returns the launch's pairs a warp."""
    from usearch12_tpu_torch import _build
    from usearch12_tpu_torch.ops import banded_nw as bn
    import ctypes
    batch = bn.pack_pairs(pairs, True, radius)
    args = tuple(torch.from_numpy(x).to(card) for x in (
        batch.a_let, batch.b_let, batch.la, batch.lb, batch.dlo, batch.bw))
    gp = wnw.gap_params(ap).to(card)
    tb, mlast, dlb = bn.banded_nw_fwd(*args, gp, *wnw.match_mismatch(ap))
    stride = (int((batch.la + batch.lb).max()) + 3) // 4
    for t in (tb, None):
        n0 = bn.banded_nw_chase.launches
        got = bn.banded_nw_chase(t, mlast, dlb, *args[2:], gp)
        assert bn.banded_nw_chase.launches == n0 + 1
        want = bn.banded_nw_chase_plain(t, mlast, dlb, *args[2:], gp, stride)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert (x is None and y is None) or _bit_equal(x, y)
    geo = (ctypes.c_int * 3)()
    assert _build.load_library().banded_nw_chase_geometry(
        len(pairs), mlast.shape[1], stride, 1, geo) > 0
    return geo[0]


@pytest.mark.parametrize("bw,n", [(1, 203), (2, 203), (33, 203), (64, 203),
                                  (121, 203), (126, 203), (33, 66000),
                                  (126, 66000)])
def test_banded_nw_chase_every_band(card, bw, n):
    """The chase kernel at bands 1-126, one pair a warp (203 pairs) and 32
    (66,000), pairs of several la in one warp, la > lb, la < lb, la ==
    lb, the last pair's top window ending at tb's last byte."""
    pairs = _band_pairs(np.random.default_rng(bw + n), n, bw)
    # the longest last: its top window ends at tb's last byte
    pairs.sort(key=lambda x: len(x[0]))
    G = _assert_chase_matches_plain(
        card, pairs, 0, wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4))
    assert G == (32 if n == 66000 else 1)


@pytest.mark.parametrize("n", [97, 40000])
def test_banded_nw_chase_lopsided(card, n):
    """Main-diagonal bands of pairs three times longer on one side than
    the other (long final-row and Drow[LB] runs), radius 20."""
    rng = np.random.default_rng(n)
    conv = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k in range(n):
        la = int(rng.integers(30, 120))
        a = conv[rng.integers(0, 4, la)]
        b = a.copy()
        b[rng.random(la) < 0.1] = conv[rng.integers(0, 4)]
        short = max(1, la // 3)
        pairs.append((a[:short], b) if k % 2 else (a, b[:short]))
    _assert_chase_matches_plain(card, pairs, 20,
                                wnw.nucleo_params(-10.0, -1.0, -0.5, -0.5))


def _hist_chunk(rng, cq, boots, uwmax, m_val, short):
    nuw = rng.integers(1, uwmax + 1, cq).astype(np.int32)
    nuw[:2] = (0, 1)
    m = np.full(cq, m_val, np.int32)
    m[2] = min(m_val, 1)
    m[3] = 0
    n = boots * max(1, max(m_val, 1) // (3 if short else 1))
    stream = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return nuw, m, stream


@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("uwmax,cq,boots", [(8, 6, 5), (8192, 6, 5),
                                            (256, 128, 100)])
@pytest.mark.parametrize("m_val", [0, 1, 127, 128, 2049])
def test_pick_hist_kernel(card, m_val, uwmax, cq, boots, short):
    """The pick histogram kernel against its plain version in the card's
    type for m: nuw = 0 and 1, m = 0 and 1, streams shorter than boots x m,
    rows of 8 and 8,192 slots and a full chunk (128 jobs x 100 boots)."""
    from usearch12_tpu_torch.ops import sintax_boot as sb
    rng = np.random.default_rng(m_val + uwmax + short)
    nuw, m, stream = _hist_chunk(rng, cq, boots, uwmax, m_val, short)
    up = lambda x: torch.from_numpy(x.view(np.int32)).to(card)  # noqa: E731
    dtype = (torch.int8 if m_val <= sb.INT8_MAX else torch.float16
             if m_val <= sb.FP16_EXACT else torch.float32)
    n0 = sb.pick_hist.launches
    got = sb.pick_hist(up(nuw), up(m), up(stream), boots, uwmax, dtype)
    want = sb.pick_hist_plain(up(nuw), up(m), up(stream), boots, uwmax,
                              dtype)
    torch.cuda.synchronize()
    assert sb.pick_hist.launches == n0 + 1
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("uwmax,dtype", [(16384, torch.float32),
                                         (65536, torch.int8),
                                         (20000, torch.float16)])
def test_pick_hist_rows_past_shared_memory(card, uwmax, dtype):
    """Rows of counters larger than a block's shared memory: each block
    counts one boot over a range of slots."""
    from usearch12_tpu_torch import _build
    from usearch12_tpu_torch.ops import sintax_boot as sb
    rng = np.random.default_rng(uwmax)
    cq, boots, m_val = 5, 7, 120
    code = {torch.float32: 0, torch.float16: 1, torch.int8: 2}[dtype]
    assert _build.load_library().sintax_pick_hist_tiles(
        boots, cq, uwmax, code) > 1
    nuw, m, stream = _hist_chunk(rng, cq, boots, uwmax, m_val, False)
    nuw[4] = uwmax
    up = lambda x: torch.from_numpy(x.view(np.int32)).to(card)  # noqa: E731
    got = sb.pick_hist(up(nuw), up(m), up(stream), boots, uwmax, dtype)
    want = sb.pick_hist_plain(up(nuw), up(m), up(stream), boots, uwmax,
                              dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(want[4].sum()) == boots * m_val


@pytest.mark.parametrize("extra", [[], ["-big", "10"],
                                   ["-big", "10", "-stepwords", "0"]])
def test_csr_ranker_on_card_matches_cpu(card, tmp_path, extra):
    """The CSR ranker on the card equals its CPU run (the torch ops in
    chunks of 32), below -big (SetTopBump, torch ops on the card in
    chunks of 32) and above it (UDBSearchBig: the kernel, one launch for
    the window as one chunk)."""
    from usearch12_tpu_torch.cli import parse_argv
    from usearch12_tpu_torch.index.udb import UDBIndex
    from usearch12_tpu_torch.io.fastx import read_fastx
    from usearch12_tpu_torch.io.seqdb import SeqDB
    from usearch12_tpu_torch.ops.csr_rank import CSRDeviceRanker
    db_fa, q_fa = _rank_db(tmp_path)
    parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                "-strand", "plus", "-quiet", *extra])
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    index = UDBIndex.from_seqdb(db)
    seqs = [s for _l, s, _q in read_fastx(q_fa, stream=True)]
    jbuf = np.ascontiguousarray(np.concatenate(seqs))
    j_off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=j_off[1:])
    ranker = CSRDeviceRanker(index, card, chunk_b=32)
    got = ranker.rank_window(jbuf, j_off)
    want = CSRDeviceRanker(index, torch.device("cpu"),
                           chunk_b=32).rank_window(jbuf, j_off)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert got[2].min() > 0
    launches = ranker.stats.get("rank_kernel_launches", 0)
    if ranker.big:
        assert ranker.chunk_b == ranker.WINDOW
        assert launches == ranker.stats["rank_chunks"] == 1
    else:
        assert ranker.chunk_b == 32 and launches == 0


def _rank_db(tmp_path):
    """80 templates of 200 nt, 5 copies of each with 1-8 substitutions:
    300 targets and 100 queries."""
    rng = np.random.default_rng(43)
    conv = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for t in range(80):
        tpl = conv[rng.integers(0, 4, 200)]
        for k in range(5):
            s = tpl.copy()
            n = int(rng.integers(1, 9))
            s[rng.integers(0, 200, n)] = conv[rng.integers(0, 4, n)]
            recs.append(s.tobytes().decode())
    order = rng.permutation(len(recs))
    db_fa, q_fa = str(tmp_path / "db.fa"), str(tmp_path / "q.fa")
    for path, part in ((db_fa, order[:300]), (q_fa, order[300:])):
        with open(path, "w") as f:
            f.writelines(f">s{i}\n{recs[i]}\n" for i in part)
    return db_fa, q_fa


def _csr(rng, V, T, size_lo, size_hi, pool):
    """A random CSR of V words over T targets as csr_arrays() gives it:
    row sizes in [size_lo, size_hi), each posting drawn from the first
    `pool` targets (so counts tie), repeats within a row allowed."""
    sizes = np.zeros(V + 1, np.int64)
    sizes[:V] = rng.integers(size_lo, size_hi, V)
    starts = np.zeros(V + 2, np.int64)
    starts[1:V + 1] = np.cumsum(sizes[:V])
    starts[V + 1] = starts[V]
    post = np.concatenate([rng.integers(0, pool, int(starts[V])),
                           [T]]).astype(np.int32)
    return starts, sizes, post


def _kernel_vs_plain(card, csr, T, qw, cap, topk=64):
    """run_chunk of the kernel route on the card against the torch ops on
    the CPU: counts, targets and nextv bit for bit, and rank_touched.
    Returns the card half's stats and its (counts, targets, nextv)."""
    from usearch12_tpu_torch.card import LocalCard
    from usearch12_tpu_torch.ops.csr_rank import csr_rank_big
    halves = [LocalCard(d).build("csr_chunks", T, *csr, topk, 0, True)
              for d in (card, torch.device("cpu"))]
    assert halves[0].whole_windows and not halves[1].whole_windows
    stats = [{}, {}]
    n0 = csr_rank_big.launches
    got, want = (h.run_chunk(qw, cap, st) for h, st in zip(halves, stats))
    torch.cuda.synchronize()
    assert csr_rank_big.launches == n0 + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert stats[0]["rank_touched"] == stats[1]["rank_touched"]
    assert stats[0]["rank_kernel_launches"] == 1
    return stats[0], got


def _pow2(n):
    return 1 << int(max(n, 64) - 1).bit_length()


@pytest.mark.parametrize("seed", [1, 2])
def test_csr_rank_kernel_ties(card, seed):
    """Random CSRs whose postings come from a small pool of targets (many
    equal counts, repeats within a row): 300 queries of up to 32 words,
    some words padding, K = 64 and K = 200."""
    rng = np.random.default_rng(seed)
    V, T = 700, 5000
    csr = _csr(rng, V, T, 0, 300, 400)
    qw = rng.integers(0, V + 1, (300, 32))
    cap = _pow2(int(csr[1][qw].sum(1).max()))
    for k in (64, 200):
        stats, _got = _kernel_vs_plain(card, csr, T, qw, cap, k)
    assert stats["rank_spills"] == 0 and stats["rank_touched"] > 0


def test_csr_rank_kernel_edges(card):
    """All-padding rows, queries with fewer touched targets than K, a
    query of one hit and rows past the largest word, in one chunk."""
    rng = np.random.default_rng(3)
    V, T = 50, 1000
    csr = _csr(rng, V, T, 0, 6, T)
    qw = np.full((8, 16), V, np.int64)
    qw[1, :3] = [0, 1, 2]
    qw[2, 5] = int(np.nonzero(csr[1][:V] == 1)[0][0])
    qw[3] = rng.integers(0, V, 16)
    stats, (cnts, tgts, nextv) = _kernel_vs_plain(card, csr, T, qw, 128)
    assert (cnts[0] == 0).all() and (tgts[0] == T).all() and nextv[0] == 0
    assert (cnts[2, 1:] == 0).all() and cnts[2, 0] == 1
    assert stats["rank_touched"] < 8 * 64


def test_csr_rank_kernel_spills(card):
    """Queries whose hits pass SMEM_HITS, and whose distinct targets pass
    the on-chip table's slots, take tables in device memory (rank_spills
    counts them); beside them queries that do not."""
    from usearch12_tpu_torch.ops import csr_rank
    rng = np.random.default_rng(4)
    V, T = 64, 200000
    csr = _csr(rng, V, T, 2500, 4500, T)
    qw = np.full((6, 8), V, np.int64)
    qw[:4] = rng.integers(0, V, (4, 8))
    qw[4, :2] = [0, 1]
    hits = csr[1][qw].sum(1)
    assert (hits[:4] > csr_rank.SMEM_HITS).all()
    assert (hits[4:] <= csr_rank.SMEM_HITS).all()
    stats, _got = _kernel_vs_plain(card, csr, T, qw, _pow2(int(hits.max())))
    assert stats["rank_spills"] == 4
    assert stats["rank_touched"] > 4 * 16384


def test_csr_rank_kernel_cap_max(card):
    """A cap of CAP_MAX: queries of exactly 2^18 hits, and one whose hit
    stream the cap cuts (the plain version's truncation), with many
    repeats."""
    from usearch12_tpu_torch.ops import csr_rank
    rng = np.random.default_rng(5)
    V, T, cap = 10, 300000, csr_rank.CSRRanker.CAP_MAX
    csr = _csr(rng, V, T, cap // 8, cap // 8 + 1, 150000)
    qw = np.full((3, 10), V, np.int64)
    qw[0, :8] = np.arange(8)
    qw[1, :8] = np.arange(2, 10)
    qw[2] = np.arange(10)
    assert csr[1][qw[0]].sum() == cap and csr[1][qw[2]].sum() > cap
    stats, _got = _kernel_vs_plain(card, csr, T, qw, cap)
    assert stats["rank_spills"] == 3


def _clade_db(tmp_path, n_clades=60, members=30, n_reads=256, length=253):
    """A DB built like gg99_v4 at test size: n_clades random templates,
    each with `members` targets 0-3 substitutions from it (ties among
    near and equal targets); reads of random targets with 0-5
    substitutions."""
    rng = np.random.default_rng(47)
    conv = np.frombuffer(b"ACGT", np.uint8)

    def mutate(s, n):
        s = s.copy()
        s[rng.integers(0, length, n)] = conv[rng.integers(0, 4, n)]
        return s

    tgts = [mutate(tpl, int(rng.integers(0, 4)))
            for tpl in (conv[rng.integers(0, 4, length)]
                        for _ in range(n_clades)) for _ in range(members)]
    reads = [mutate(tgts[int(rng.integers(0, len(tgts)))],
                    int(rng.integers(0, 6))) for _ in range(n_reads)]
    db_fa, q_fa = str(tmp_path / "db.fa"), str(tmp_path / "q.fa")
    for path, recs in ((db_fa, tgts), (q_fa, reads)):
        with open(path, "w") as f:
            f.writelines(f">s{i}\n{r.tobytes().decode()}\n"
                         for i, r in enumerate(recs))
    return db_fa, q_fa


def test_csr_ranker_clade_db_window(card, tmp_path):
    """usearch_global's ranking of 256 reads against a clade-structured
    DB of 1,800 targets above -big (UDBSearchBig, -id 0.97): the window
    as one kernel launch equals the torch ops on the CPU in candidates,
    counts, list lengths and uncertain flags, and makes nothing of the
    size of the dense count rows."""
    from usearch12_tpu_torch.cli import parse_argv
    from usearch12_tpu_torch.index.udb import UDBIndex
    from usearch12_tpu_torch.io.fastx import read_fastx
    from usearch12_tpu_torch.io.seqdb import SeqDB
    from usearch12_tpu_torch.ops.csr_rank import CSRDeviceRanker
    db_fa, q_fa = _clade_db(tmp_path)
    parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.97",
                "-strand", "plus", "-big", "100", "-quiet"])
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    index = UDBIndex.from_seqdb(db)
    seqs = [s for _l, s, _q in read_fastx(q_fa, stream=True)]
    jbuf = np.ascontiguousarray(np.concatenate(seqs))
    j_off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=j_off[1:])
    ranker = CSRDeviceRanker(index, card)
    assert ranker.dev.whole_windows and ranker.chunk_b == ranker.WINDOW
    ranker.rank_window(jbuf, j_off)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    got = ranker.rank_window(jbuf, j_off)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    cpu = CSRDeviceRanker(index, torch.device("cpu"))
    want = cpu.rank_window(jbuf, j_off)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert ranker.stats["rank_kernel_launches"] == 2
    assert ranker.stats["rank_touched"] == 2 * cpu.stats["rank_touched"]
    assert (got[1][:, 0] > 1).mean() > 0.9
    assert peak < len(seqs) * (1 << ranker.dev.t_bits) * 8 // 4


@pytest.mark.parametrize("n_queries,n_targets", [(64, 296), (5, 13)])
def test_u_counter_on_card_matches_cpu(card, tmp_path, n_queries,
                                       n_targets):
    """DeviceUCounter.count on cuda:0 (torch._int_mm) equals its CPU run:
    64 queries against 296 centroids (the product's sizes as they come),
    and 5 against 13 (rows and centroids padded), after a first
    allocation and after rows written in place."""
    from usearch12_tpu_torch.cli import parse_argv
    from usearch12_tpu_torch.index.udb import UDBIndex, UDBParams
    from usearch12_tpu_torch.io.fastx import read_fastx
    from usearch12_tpu_torch.parallel.cluster_batch import DeviceUCounter
    from usearch12_tpu_torch.parallel.mesh import single_mesh
    db_fa, q_fa = _rank_db(tmp_path)
    parse_argv(["-cluster_mt", db_fa, "-id", "0.97", "-quiet"])
    seqs = [s for _l, s, _q in read_fastx(db_fa, stream=True)]
    queries = [s for _l, s, _q in read_fastx(q_fa, stream=True)][:n_queries]
    index = UDBIndex(UDBParams.global_usearch(True))
    counters = [DeviceUCounter(single_mesh(d)) for d in (card, "cpu")]
    for lo, hi in ((0, n_targets - 3), (n_targets - 3, n_targets)):
        for k in range(lo, hi):
            index.add_seq(k, seqs[k])
            index.seq_count = k + 1
        for c in counters:
            c.note_admitted(index, seqs[lo:hi])
            c.refresh(index)
        got, want = (c.count(index, queries) for c in counters)
        assert got.shape == (n_queries, hi) and np.array_equal(got, want)
    assert counters[0].stats["allocs"] == 1 and got.max() > 0
    assert counters[0].stats["count_ms"] > 0


@pytest.mark.parametrize("n_db,extra", [(1, []), (4, []),
                                        (4, ["-big", "10"])])
def test_mesh_ranker_on_card_matches_cpu(card, tmp_path, n_db, extra):
    """MeshRanker on a 1 x n_db mesh of cuda:0 equals its CPU run (below
    -big: the sharded product, prefix maxima and top K; above it: the CSR
    ranker's big mode)."""
    from usearch12_tpu_torch.cli import parse_argv
    from usearch12_tpu_torch.index.udb import UDBIndex
    from usearch12_tpu_torch.io.fastx import read_fastx
    from usearch12_tpu_torch.io.seqdb import SeqDB
    from usearch12_tpu_torch.parallel.mesh import single_mesh
    from usearch12_tpu_torch.parallel.mesh_search import MeshRanker
    db_fa, q_fa = _rank_db(tmp_path)
    parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                "-strand", "plus", "-quiet", *extra])
    db = SeqDB.from_fastx(db_fa)
    db.mask()
    index = UDBIndex.from_seqdb(db)
    seqs = [s for _l, s, _q in read_fastx(q_fa, stream=True)]
    jbuf = np.ascontiguousarray(np.concatenate(seqs))
    j_off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=j_off[1:])
    got, want = (MeshRanker(single_mesh(torch.device(d), n_db), index)
                 .rank_window(jbuf, j_off) for d in (card, "cpu"))
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert got[2].min() > 0



def _step_pairs(seed, n):
    """Query and target letter rows of n pairs at lengths 20-256 (bands of
    the step from 33 to above 128 lanes), a few queries with Ns."""
    from usearch12_tpu_torch.parallel import search_step as ss
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    qs, ts = [], []
    for k in range(n):
        la = int(rng.integers(20, 257))
        lb = int(np.clip(la + rng.integers(-120, 121), 20, 256))
        a = conv[rng.integers(0, 4, la)]
        b = np.resize(a, lb)
        b[rng.random(lb) < 0.1] = conv[rng.integers(0, 4)]
        if k % 7 == 0:
            a[rng.integers(0, la, 2)] = ord("N")
        qs.append(a)
        ts.append(b)
    return (torch.from_numpy(ss.letter_rows(qs, 256)),
            torch.from_numpy(ss.letter_rows(ts, 256)),
            torch.tensor([len(t) for t in ts], dtype=torch.int32))


def test_banded_score_route_matches_plain_versions(card):
    """banded_nw_fwd without traceback and banded_nw_chase with tb None (the
    step's score route) bit-equal to their plain versions at the step's
    bands, 1,000 pairs of 20-256 nt."""
    from usearch12_tpu_torch.ops import banded_nw as bn
    from usearch12_tpu_torch.parallel import search_step as ss
    a, b, lb = _step_pairs(5, 1000)
    la = (a != ss.PAD_LETTER).sum(1, dtype=torch.int32)
    dlo, bw = ss.step_band(la, lb)
    keep = bw <= bn.BAND_LANES
    args = [x[keep].contiguous() for x in (a, b, la, lb, dlo, bw)]
    gp = wnw.gap_params(wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4))
    fwd = bn.banded_nw_fwd(*(x.to(card) for x in args), gp.to(card), 1.0,
                           -2.0, with_traceback=False)
    plain = bn.banded_nw_fwd_plain(*args, gp, 1.0, -2.0, fwd[1].shape[1],
                                   with_traceback=False)
    assert fwd[0] is None and plain[0] is None
    for x, y in zip(fwd[1:], plain[1:]):
        assert _bit_equal(x.cpu(), y)
    geo = [x.to(card) for x in args[2:]]
    ch = bn.banded_nw_chase(None, fwd[1], fwd[2], *geo, gp.to(card))
    ch_plain = bn.banded_nw_chase_plain(None, plain[1], plain[2], *args[2:],
                                        gp, 1)
    assert ch[3] is None and ch_plain[3] is None
    for x, y in zip(ch[:3], ch_plain[:3]):
        assert _bit_equal(x.cpu(), y)


def test_search_step_on_card_matches_cpu(card):
    """make_search_step on cuda:0 and make_sharded_search_step on a 1x4
    and a 2x2 mesh of it equal the CPU step: the entry's data, and pairs
    whose bands run from 33 to above 128 lanes (the wide ones on the hole
    DP's kernels) with Ns in some queries."""
    from usearch12_tpu_torch import entry
    from usearch12_tpu_torch.ops import banded_nw as bn
    from usearch12_tpu_torch.parallel import search_step as ss
    from usearch12_tpu_torch.parallel.mesh import single_mesh
    cpu = torch.device("cpu")
    a, b, lb = _step_pairs(9, 200)
    n = a.shape[0]
    eye = torch.zeros((n, n), dtype=torch.int8)
    eye.fill_diagonal_(1)
    gp = torch.tensor(entry.GAP_PENALTIES)
    cases = [entry._example_data(n_queries=40, seed=5, device=cpu),
             (eye, eye, a, b, lb, gp)]
    for args in cases:
        want = ss.make_search_step(256, cpu)(*args)
        n0 = bn.banded_nw_fwd.launches
        steps = [ss.make_search_step(256, card),
                 ss.make_sharded_search_step(single_mesh(card, 4), 256),
                 ss.make_sharded_search_step(single_mesh(card, 2, 2), 256)]
        for step in steps:
            got = step(*(x.to(card) for x in args))
            for x, y in zip(got, want):
                assert x.device.type == "cuda" and _bit_equal(x.cpu(), y)
        assert bn.banded_nw_fwd.launches > n0


def test_align_sharded_on_card_matches_align(card):
    """TorchWaveAligner.align_sharded over a "data" axis of 4 entries of
    cuda:0 equals align() on the card and on the CPU."""
    from usearch12_tpu_torch.parallel.mesh import Mesh
    ap = wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4)
    pairs = _pairs(11, 101, 40, 600)
    aligner = wnw.TorchWaveAligner(ap, card)
    s1, p1 = aligner.align(pairs, 24)
    s2, p2 = aligner.align_sharded(pairs, 24, Mesh([[card]] * 4))
    s3, p3 = wnw.TorchWaveAligner(ap, torch.device("cpu")).align(pairs, 24)
    assert s1.tobytes() == s2.tobytes() == s3.tobytes()
    assert p1 == p2 == p3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def index_of(v, t, sizes, postings):
    """What names a DB of these CSR arrays on the server (db_signature):
    an index's word slots, targets and postings."""
    from types import SimpleNamespace
    return SimpleNamespace(params=SimpleNamespace(slot_count=v),
                           seq_count=t, sizes=np.asarray(sizes),
                           postings=np.asarray(postings))


def start_server(tmp, device="cpu", idle=60.0):
    """A server of this checkout on `device`, its socket under `tmp` (as
    a client with TMPDIR=tmp finds it), answering: (process, client)."""
    env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT)
    log = open(os.path.join(tmp, "server.out"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "usearch12_tpu_torch.device_server",
         "--device", device, "--idle", str(idle)], env=env, stdout=log,
        stderr=log, cwd=ROOT)
    log.close()
    cli = ds.DeviceServerClient(ds.server_paths(tmp), timeout=600.0)
    deadline = time.monotonic() + 600
    while True:
        try:
            cli.ping()
            return proc, cli
        except ds.DeviceServerError:
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                with open(os.path.join(tmp, "server.out")) as f:
                    raise RuntimeError("server did not start: " + f.read())
            time.sleep(0.1)


def stop_server(proc, cli):
    try:
        cli.shutdown()
    except ds.DeviceServerError:
        pass
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def card_server():
    """A resident device server of this checkout on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = tempfile.mkdtemp(prefix="u12t-", dir="/tmp")
    proc, cli = start_server(d, device="cuda")
    try:
        yield cli
    finally:
        stop_server(proc, cli)
        shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("radius", [16, 120])
def test_server_align_equals_in_process(card, card_server, radius):
    """align on the server card's aligner (op align, one launch of each
    hole DP kernel a class) is bit-equal to TorchWaveAligner in this
    process, for two terminal-penalty classes."""
    from usearch12_tpu_torch.card import ServerCard
    ap = wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4)
    pairs = _pairs(radius, 200, 50, 1200)
    for cls in (0, 5):
        n0 = card_server.ping()["launches"]
        s_srv, p_srv = ServerCard(card_server).aligner(ap, cls).align(
            pairs, radius)
        n1 = card_server.ping()["launches"]
        s_in, p_in = wnw.TorchWaveAligner(ap.hole_params(
            *(bool(cls & b) for b in (1, 2, 4, 8))), card).align(pairs,
                                                                 radius)
        assert np.array_equal(s_srv.view(np.int32), s_in.view(np.int32))
        assert p_srv == p_in
        assert n1["wavefront_fwd"] > n0["wavefront_fwd"]
        assert n1["wavefront_trace"] > n0["wavefront_trace"]
    assert card_server.ping()["device"] == "cuda:0"


@pytest.mark.parametrize("m_val,mmax", [(32, 32), (200, 256), (3000, 4096)])
def test_server_sintax_boots_equal_in_process(card, card_server, m_val,
                                              mmax):
    """sintax_boots on the server card's boot engine (sintax_load once)
    is bit-equal to TorchBootEngine.run_chunk in this process; m > 2048
    included."""
    from usearch12_tpu_torch.amplicon.sintax_device import TorchBootEngine
    from usearch12_tpu_torch.card import ServerCard
    from usearch12_tpu_torch.config import reset_options
    rng = np.random.default_rng(m_val)
    cq, boots, uwmax, v, t = 16, 20, 32, 256, 700
    sizes = rng.integers(0, 6, v)
    posts = np.concatenate([rng.choice(t, int(s), replace=False)
                            for s in sizes]).astype(np.int32)
    nuw = rng.integers(8, uwmax + 1, cq).astype(np.int32)
    words = np.zeros((cq, uwmax), np.int32)
    for k in range(cq):
        words[k, :nuw[k]] = rng.choice(v, nuw[k], replace=False)
    m = np.full(cq, m_val, np.int32)
    stream = rng.integers(0, 2 ** 32, boots * mmax,
                          dtype=np.uint64).astype(np.uint32)
    rr = rng.integers(0, 2 ** 32, (cq, boots),
                      dtype=np.uint64).astype(np.uint32)
    db = (v, t, sizes, posts, boots)
    chunk = (words, nuw, m, stream, rr)
    n0 = card_server.ping()
    reset_options()
    got = ServerCard(card_server).boot_engine(
        index_of(*db[:4]), lambda: db[:4], boots).run_chunk(*chunk)
    n1 = card_server.ping()
    want = TorchBootEngine(*db, card).run_chunk(*chunk)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert n1["served"]["sintax_load"] == n0["served"]["sintax_load"] + 1
    for k in ("sintax_pick_hist", "sintax_boot_count_select"):
        assert n1["launches"][k] > n0["launches"][k], k
