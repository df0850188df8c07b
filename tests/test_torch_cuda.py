"""usearch12_tpu_torch's CUDA kernels against their plain PyTorch versions
and the oracle, on the card.  Marked `cuda`; they skip where no card is
present.  Run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from usearch12_tpu.align.oracle import banded_nw_main_diag
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
    """The CSR ranker's torch ops on the card equal their CPU run, below
    -big (SetTopBump) and above it (UDBSearchBig)."""
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
    got = CSRDeviceRanker(index, card, chunk_b=32).rank_window(jbuf, j_off)
    want = CSRDeviceRanker(index, torch.device("cpu"),
                           chunk_b=32).rank_window(jbuf, j_off)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert got[2].min() > 0


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
