"""usearch12_tpu_torch's row-sweep banded NW (ops/banded_nw.py) on the CPU,
where BandedNWDevice's kernels run their plain PyTorch versions, against
the JAX package's judges: align/oracle.py:banded_nw and the host C kernel
nw_band.  Tolerance 0: scores equal as float32, paths equal as strings."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from usearch12_tpu.align.oracle import (band_diag_range, banded_nw,
                                        banded_nw_main_diag)
from usearch12_tpu.ops import banded_nw as jax_bnw
from usearch12_tpu_torch.ops import banded_nw as bn
from usearch12_tpu_torch.ops.wavefront_nw import (gap_params,
                                                  native_nw_band,
                                                  nucleo_params)

CPU = torch.device("cpu")
CONV = np.frombuffer(b"ACGTN", np.uint8)
DYADIC = (-10.0, -1.0, -0.5, -0.5)
NON_DYADIC = (-10.3, -1.1, -0.7, -0.4)
# banded_nw_fwd's kernel constants, read from its source so that the
# schedule model below follows the kernel: the traceback rows copied out
# at a time, and the widest band at 6 cells a part (4 above it)
_CU = (Path(bn.__file__).resolve().parents[1] / "csrc" /
       "banded_nw.cu").read_text()
FLUSH_ROWS = int(re.search(r"#define BNW_FLUSH (\d+)", _CU)[1])
CV6_MAX = int(re.search(r"#define BNW_CV6_MAX (\d+)", _CU)[1])


def kernel_cells(width):
    """The cells a part banded_nw_fwd's kernel takes at launch width
    `width` (csrc/banded_nw.cu banded_nw_fwd_cells)."""
    return 4 if width > CV6_MAX else 6


def rand_pairs(rng, n, lmin, lmax, dl=0, n_rate=0.0, lower=0.0):
    """n pairs: b is a with ~10% substitutions, cut or extended by up to
    dl letters; a fraction n_rate of a's letters are N and a fraction
    `lower` of both sequences' letters are lowercase."""
    pairs = []
    for _ in range(n):
        la = int(rng.integers(lmin, lmax))
        a = rng.integers(0, 4, la)
        a[rng.random(la) < n_rate] = 4
        b = a.copy()
        k = max(1, la // 10)
        b[rng.integers(0, la, k)] = rng.integers(0, 4, k)
        d = int(rng.integers(-dl, dl + 1)) if dl else 0
        if d > 0:
            b = np.concatenate([b, rng.integers(0, 4, d)])
        elif d < 0 and la + d >= 1:
            b = b[:la + d]
        a, b = CONV[a], CONV[b]
        a[rng.random(len(a)) < lower] += 32
        b[rng.random(len(b)) < lower] += 32
        pairs.append((a, b))
    return pairs


def indel_fixture(seed=11, n=48):
    """Pairs of 60-120 nt with up to 12 substitutions and up to 6 indels
    of 1-5 nt."""
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(n):
        L = int(rng.integers(60, 120))
        a = conv[rng.integers(0, 4, L)]
        b = list(a)
        for _ in range(int(rng.integers(0, 12))):
            b[int(rng.integers(0, len(b)))] = int(conv[rng.integers(0, 4)])
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, len(b)))
            if rng.integers(0, 2):
                del b[p:p + int(rng.integers(1, 6))]
            else:
                b[p:p] = list(conv[rng.integers(0, 4, int(rng.integers(1, 6)))])
        pairs.append((a, np.array(b, np.uint8)))
    return pairs


def assert_matches_judges(pairs, radius, ap, native=True):
    """align and align_device against the oracle (and nw_band for
    main-diagonal bands)."""
    dev = bn.BandedNWDevice(ap, CPU)
    s1, p1 = dev.align(pairs, radius)
    s2, p2 = dev.align_device(pairs, radius)
    assert s1.dtype == np.float32 and s2.dtype == np.float32
    for k, pair in enumerate(pairs):
        if len(pair) >= 4:
            s_o, p_o = banded_nw(pair[0], pair[1], pair[2], pair[3], ap)
        else:
            s_o, p_o = banded_nw_main_diag(pair[0], pair[1], radius, ap)
        assert np.float32(s_o) == s1[k] == s2[k], (k, len(pair[0]))
        assert p_o == p1[k] == p2[k], (k, len(pair[0]))
    if native:
        s_n, p_n = native_nw_band(pairs, radius, ap)
        assert np.array_equal(s_n, s1) and p_n == p1


@pytest.mark.parametrize("pen", [DYADIC, NON_DYADIC])
@pytest.mark.parametrize("seed", [1, 2])
def test_random_pairs_radius_16(seed, pen):
    rng = np.random.default_rng(seed)
    pairs = rand_pairs(rng, 10, 20, 120, dl=12, n_rate=0.05, lower=0.2)
    assert_matches_judges(pairs, 16, nucleo_params(*pen))


@pytest.mark.parametrize("pen", [DYADIC, NON_DYADIC])
def test_widest_band(pen):
    """Radius 62 gives bands of 125 (la == lb) and 126 (|la - lb| == 1),
    the widest the kernel takes."""
    rng = np.random.default_rng(62)
    pairs = rand_pairs(rng, 4, 150, 200, n_rate=0.02)
    pairs.append((pairs[0][0], pairs[0][1][:-1]))
    widths = [band_diag_range(len(a), len(b), 62) for a, b in pairs]
    assert {hi - lo + 1 for lo, hi in widths} == {125, 126}
    assert_matches_judges(pairs, 62, nucleo_params(*pen))


def test_length_one_sequences():
    rng = np.random.default_rng(5)
    pairs = [(CONV[rng.integers(0, 4, 1)], CONV[rng.integers(0, 4, 30)]),
             (CONV[rng.integers(0, 4, 30)], CONV[rng.integers(0, 4, 1)]),
             (CONV[:1], CONV[:1]), (CONV[:1], CONV[1:2]),
             (CONV[4:5], CONV[rng.integers(0, 4, 5)])]
    for radius in (0, 3, 16):
        assert_matches_judges(pairs, radius, nucleo_params(*NON_DYADIC))


@pytest.mark.parametrize("cls", [0, 5, 10, 15])
def test_hole_terminal_classes(cls):
    rng = np.random.default_rng(100 + cls)
    ap = nucleo_params(*NON_DYADIC).hole_params(
        bool(cls & 1), bool(cls & 2), bool(cls & 4), bool(cls & 8))
    assert_matches_judges(rand_pairs(rng, 6, 10, 80, dl=8), 8, ap)


def test_explicit_bands():
    """(a, b, dlo, dhi) pairs: bands off the main diagonal's default,
    narrow and lopsided, against the oracle's banded_nw."""
    rng = np.random.default_rng(7)
    base = rand_pairs(rng, 6, 30, 90, dl=10, n_rate=0.05)
    pairs = []
    for k, (a, b) in enumerate(base):
        la, lb = len(a), len(b)
        lo_room, hi_room = [(0, 0), (3, 0), (0, 5), (7, 2), (1, 40),
                            (min(la, lb) - 1, 1)][k]
        dlo = max(1, min(la, lb) - lo_room)
        dhi = min(max(la, lb) + hi_room, la + lb - 1, dlo + 125)
        pairs.append((a, b, dlo, dhi))
    assert_matches_judges(pairs, 0, nucleo_params(*NON_DYADIC), native=False)


@pytest.mark.parametrize("pen", [DYADIC, NON_DYADIC, (-3.3, -0.7, -0.3, -0.1)])
def test_indel_fixture_equals_oracle(pen):
    """The fixture on which the TPU kernel's doubling scan departs from
    the oracle for non-dyadic penalties: the port equals the oracle on
    every pair."""
    assert_matches_judges(indel_fixture(), 24, nucleo_params(*pen),
                          native=False)


def test_run_batch_without_traceback():
    rng = np.random.default_rng(3)
    pairs = rand_pairs(rng, 8, 20, 100, dl=9)
    dev = bn.BandedNWDevice(nucleo_params(*NON_DYADIC), CPU)
    batch = bn.pack_pairs(pairs, True, 16)
    s1, st1, tb1, tl1 = dev.run_batch(batch)
    s2, st2, tb2, tl2 = dev.run_batch(batch, with_traceback=False)
    assert tb2 is None and tb1.shape == (len(pairs), batch.la.max(),
                                         batch.bw.max() + 1)
    assert np.array_equal(s1, s2) and np.array_equal(st1, st2)
    assert np.array_equal(tl1, tl2) and st1.dtype == np.dtype("U1")


def test_pack_pairs_refuses_what_the_jax_package_refuses():
    rng = np.random.default_rng(4)
    a = CONV[rng.integers(0, 4, 100)]
    pairs = [(a, a.copy())]
    for mod in (jax_bnw, bn):
        mod.pack_pairs(pairs, True, 62)
        with pytest.raises(ValueError):        # band 127
            mod.pack_pairs(pairs, True, 63)
    with pytest.raises(ValueError):
        bn.pack_pairs(pairs, False, 16)
    with pytest.raises(ValueError):
        bn.BandedNWDevice(nucleo_params(*DYADIC), CPU).align(
            pairs, 16, nucleo=False)
    with pytest.raises(ValueError):            # end cell outside the band
        bn.pack_pairs([(a, a[:90], 50, 95)], True, 16)
    with pytest.raises(ValueError):
        bn.pack_pairs([], True, 16)


def test_decode_packed_ops_matches_jax():
    rng = np.random.default_rng(13)
    packed = rng.integers(0, 256, (40, 9)).astype(np.uint8)
    packed[::3] |= 0xC0          # some rows end in padding
    packed[5] = 0xFF
    assert bn.decode_packed_ops(packed, 37) == jax_bnw.decode_packed_ops(
        packed, 37)


@pytest.mark.parametrize("cls", [0, 9, 15])
def test_gap_params_match_jax(cls):
    ap = nucleo_params(*NON_DYADIC).hole_params(
        bool(cls & 1), bool(cls & 2), bool(cls & 4), bool(cls & 8))
    jdev = jax_bnw.BandedNWDevice(ap, pb=8)
    dev = bn.BandedNWDevice(ap, CPU)
    assert np.array_equal(dev.gp.numpy(), jdev.gp[0])
    assert np.array_equal(gap_params(ap).numpy(), jdev.gp[0])
    assert (dev.match, dev.mismatch) == (jdev.match, jdev.mismatch)
    assert bn.BAND_LANES == jax_bnw.BAND_LANES
    assert np.float32(bn.NEG) == jax_bnw.NEG


def test_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(1)
    batch = bn.pack_pairs(rand_pairs(rng, 3, 10, 20), True, 4)
    args = [torch.from_numpy(x) for x in (batch.a_let, batch.b_let, batch.la,
                                         batch.lb, batch.dlo, batch.bw)]
    gp = gap_params(nucleo_params(*DYADIC))
    with pytest.raises(ValueError):
        bn.banded_nw_fwd(*(x.to("meta") for x in args), gp.to("meta"),
                         1.0, -2.0)
    with pytest.raises(ValueError):
        bn.banded_nw_fwd(args[0].to(torch.int32), *args[1:], gp, 1.0, -2.0)
    with pytest.raises(ValueError):            # letter rows shorter than lb
        bn.banded_nw_fwd(args[0], args[1][:, :5].contiguous(), *args[2:],
                         gp, 1.0, -2.0)
    tb, mlast, dlb = bn.banded_nw_fwd(*args, gp, 1.0, -2.0)
    with pytest.raises(ValueError):            # mlast narrower than the band
        bn.banded_nw_chase(tb, mlast[:, :3].contiguous(), dlb, *args[2:], gp)
    with pytest.raises(ValueError):            # tb of another shape
        bn.banded_nw_chase(tb[:, :-1].contiguous(), mlast, dlb, *args[2:],
                           gp)
    assert bn.banded_nw_fwd.launches == 0
    assert bn.banded_nw_chase.launches == 0


def fwd_geometry(width, cells):
    """(lanes a pair L, pairs a warp G, traceback ring rows R) of
    banded_nw_fwd's kernel at launch width `width` and `cells` cells a
    part (csrc/banded_nw.cu bnw_fwd_launch)."""
    lanes = -(-width // (2 * cells))
    assert lanes <= 32
    ring = -(-(FLUSH_ROWS + lanes - 1) // FLUSH_ROWS) * FLUSH_ROWS
    return lanes, 32 // lanes, ring


def fwd_schedule_model(batch, gp, match, mismatch, cells):
    """banded_nw_fwd's kernel schedule (csrc/banded_nw.cu), step by step
    and lane by lane, in numpy float32, batched over pairs: groups of L
    lanes a pair and G pairs a warp; lane l does row s - l at super-step
    s, its part 2l (slots 2l*cells ..) at step 2s and part 2l + 1 at step
    2s + 1; the I state entering part 2l and the up slot and Drow[LB] of
    part 2l + 1 come from the neighbouring lanes as shuffles read them;
    the Drow[LB] chain carried by the part that holds k_lb; the rows
    staged in a ring of R rows and copied out every FLUSH_ROWS rows.
    Asserts that every value a cell reads (diagonal, up, the I state, the
    chain) was written for the row before (or, for the I state, this row)
    at an earlier step, and that a flushed ring row holds the row it
    should.  Returns (tb (P, amax, W + 1), mlast (P, W), dlb (P,))."""
    f32 = np.float32
    P, amax = batch.a_let.shape
    la, lb, dlo, bw = (x.astype(np.int64) for x in (batch.la, batch.lb,
                                                     batch.dlo, batch.bw))
    W = int(bw.max())
    L, G, R = fwd_geometry(W, cells)
    NS = 2 * L * cells                       # slots of a group's parts
    neg = f32(bn.NEG)
    g = [f32(x) for x in np.asarray(gp[:12])]
    (open_a, open_b, ext_a, ext_b, l_open_a, l_open_b, _r_open_a, r_open_b,
     l_ext_a, l_ext_b, _r_ext_a, r_ext_b) = g
    match, mismatch = f32(match), f32(mismatch)
    rows = np.arange(P)
    M = np.full((P, NS + 1), neg, f32)       # slot NS: past the last lane
    D = np.full((P, NS + 1), neg, f32)
    M[rows, la - dlo] = 0
    w_row = np.full((P, NS + 1), -1)         # row and step of each slot's
    w_step = np.full((P, NS + 1), -1)        # last write
    dlb = np.full((P, L), neg, f32)          # each lane's chain register
    dlb_row = np.full((P, L), -1)
    i_out = np.full((P, L), neg, f32)        # I state after part 2l + 1
    i_out_row = np.full((P, L), -1)
    i_out_step = np.full((P, L), -1)
    ring = np.zeros((P, R, W + 1), np.uint8)
    ring_tag = np.full((P, R), -1)
    tb = np.full((P, amax, W + 1), 0xEE, np.uint8)  # every byte is written
    mlast = np.full((P, W), np.nan, f32)
    dlb_out = np.full(P, np.nan, f32)
    la_max = np.zeros(P, np.int64)
    for w0 in range(0, P, G):
        la_max[w0:w0 + G] = la[w0:w0 + G].max()
    s_end = la_max + L - 2
    n_chunks = -(-amax // FLUSH_ROWS)
    flushed = np.zeros(P, np.int64)

    def flush(q, live):
        r0 = q * FLUSH_ROWS
        for r in range(r0, min(r0 + FLUSH_ROWS, amax)):
            done = live & (r < la)
            assert (ring_tag[done, r % R] == r).all()
            tb[done, r] = ring[done, r % R]
            tb[live & (r >= la), r] = 0
        flushed[live] += 1

    def part(s, l, v, i0, up, prev, prev_row):
        """Part v of lane l at super-step s; returns the I state after
        it."""
        i = s - l
        t = 2 * s + (v - 2 * l)
        act = (i >= 0) & (i < la)
        if not act.any():
            return i0
        jbase = dlo + i - la
        kstart = np.maximum(0, -jbase)
        kend = np.minimum(lb - jbase, bw)
        ring_tag[act, i % R] = i
        k_lb = lb - dlo - i + la
        own = act & (np.minimum(k_lb, NS - 1) // cells == v)
        if own.any():
            assert (prev_row[own] == i - 1).all()
            held = own & (k_lb < bw)
            assert (k_lb[held] // cells == v).all()
            assert (w_row[held, k_lb[held]] <= i - 1).all()
            assert (w_step[held, k_lb[held]] < t).all()
            m_end = np.where(held, M[rows, np.clip(k_lb, 0, NS)], neg)
            md_lb = m_end + r_open_b
            de_lb = prev + r_ext_b
            take_lb = md_lb >= de_lb
            dlb[own, l] = np.where(take_lb, md_lb, de_lb)[own]
            dlb_row[own, l] = i
            ring[own, i % R, W] = np.where(take_lb, bn.TB_MD, 0)[own]
            last = own & (i == la - 1)
            dlb_out[last] = dlb[last, l]
        ca = batch.a_let[:, min(i, amax - 1)].astype(np.int64)
        oa, ea = (l_open_a, l_ext_a) if i == 0 else (open_a, ext_a)
        for c in range(cells):
            k = v * cells + c
            valid = act & (k >= kstart) & (k < kend)
            # the up slot: in the part, or the next part's first (own
            # registers for part 2l, lane l + 1's shuffled for 2l + 1)
            ku = k + 1 if c + 1 < cells or up is None else None
            if valid.any():
                for kk in (k, k + 1):
                    assert (w_row[valid, kk] <= i - 1).all()
                    assert (w_step[valid, kk] < t).all()
            j = jbase + k
            cb = batch.b_let[rows, np.clip(j, 0, batch.b_let.shape[1] - 1)]
            cb = cb.astype(np.int64)
            sub = np.where((ca < 4) & (cb < 4),
                           np.where(ca == cb, match, mismatch), f32(0))
            ob = np.where(j == 0, l_open_b, open_b)
            eb = np.where(j == 0, l_ext_b, ext_b)
            m_diag = M[:, k].copy()
            d_up = D[:, ku] if ku is not None else up
            take_d = d_up > m_diag
            xm = np.where(take_d, d_up, m_diag)
            take_i = i0 > xm
            xm = np.where(take_i, i0, xm)
            md = m_diag + ob
            de = d_up + eb
            take_open = md >= de
            mi = m_diag + oa
            ie = i0 + ea
            take_iopen = mi >= ie
            M[valid, k] = (xm + sub)[valid]
            D[valid, k] = np.where(take_open, md, de)[valid]
            i0 = np.where(valid, np.where(take_iopen, mi, ie), i0)
            w_row[valid, k] = i
            w_step[valid, k] = t
            bits = (np.where(take_i, bn.TB_IM, np.where(take_d, bn.TB_DM, 0))
                    | np.where(take_open, bn.TB_MD, 0)
                    | np.where(take_iopen, bn.TB_MI, 0))
            if k < W:
                ring[act, i % R, k] = np.where(valid, bits, 0)[act]
        last = act & (i == la - 1)
        for c in range(cells):
            k = v * cells + c
            if k < W:
                mlast[last, k] = np.where(k < kend, M[:, k], neg)[last]
        return i0

    for s in range(int(s_end.max()) + 1):
        # shuffle up: the I state each lane left after its last row
        i_in = np.concatenate([np.full((P, 1), neg, f32), i_out[:, :-1]], 1)
        i_in_row = np.concatenate([np.full((P, 1), -1), i_out_row[:, :-1]],
                                  1)
        i_in_step = np.concatenate([np.full((P, 1), -1), i_out_step[:, :-1]],
                                   1)
        mid = []
        for l in range(L):
            i = s - l
            act = (i >= 0) & (i < la)
            if l > 0:
                assert (i_in_row[act, l] == i).all()
                assert (i_in_step[act, l] < 2 * s).all()
            mid.append(part(s, l, 2 * l, i_in[:, l], None, dlb[:, l],
                            dlb_row[:, l]))
        # shuffle down: lane l + 1's first D slot and chain register
        up = np.concatenate([D[:, 2 * cells:NS:2 * cells],
                             np.full((P, 1), neg, f32)], 1)
        d_right = np.concatenate([dlb[:, 1:], np.full((P, 1), neg, f32)], 1)
        d_right_row = np.concatenate([dlb_row[:, 1:],
                                      np.full((P, 1), -1)], 1)
        for l in range(L):
            i = s - l
            act = (i >= 0) & (i < la)
            k_lb = lb - dlo - i + la
            from_right = np.minimum(k_lb + 1, NS - 1) // cells == 2 * l + 2
            prev = np.where(from_right, d_right[:, l], dlb[:, l])
            prev_row = np.where(from_right, d_right_row[:, l], dlb_row[:, l])
            out = part(s, l, 2 * l + 1, mid[l], up[:, l], prev, prev_row)
            i_out[act, l] = out[act]
            i_out_row[act, l] = i
            i_out_step[act, l] = 2 * s + 1
        q = s - (L - 2)
        if q > 0 and q % FLUSH_ROWS == 0 and q // FLUSH_ROWS <= n_chunks:
            flush(q // FLUSH_ROWS - 1, s <= s_end)
    for q in range(n_chunks):
        flush(q, flushed == q)
    assert (flushed == n_chunks).all()
    return tb, mlast, dlb_out


def band_pairs(rng, n, bw, lmin=20, lmax=160):
    """n (a, b, dlo, dhi) pairs whose band is exactly bw wide, la > lb,
    la < lb and la == lb in turns, the band placed at random where it
    holds the start and end cells."""
    pairs = []
    for k in range(n):
        la = int(rng.integers(max(lmin, bw), lmax))
        d = 0 if bw == 1 else int(rng.integers(1, min(bw, 12)))
        lb = la + (d, -d, 0)[k % 3]
        lo_min = max(1, max(la, lb) - bw + 1)
        dlo = int(rng.integers(lo_min, min(la, lb) + 1))
        a = CONV[rng.integers(0, 4, la)]
        b = np.resize(a, lb).copy()
        flip = rng.random(lb) < 0.12
        b[flip] = CONV[rng.integers(0, 5, int(flip.sum()))]
        pairs.append((a, b, dlo, dlo + bw - 1))
    return pairs


def assert_model_matches(pairs, radius, ap, cells=None):
    """The schedule model's (tb, mlast, dlb) bit-equal to
    banded_nw_fwd_plain's; its scores and paths (through the chase) equal
    to the oracle's."""
    batch = bn.pack_pairs(pairs, True, radius)
    gp = gap_params(ap)
    match, mismatch = bn.match_mismatch(ap)
    W = int(batch.bw.max())
    cells = kernel_cells(W) if cells is None else cells
    got = fwd_schedule_model(batch, gp.numpy(), match, mismatch, cells)
    args = [torch.from_numpy(x) for x in (batch.a_let, batch.b_let, batch.la,
                                         batch.lb, batch.dlo, batch.bw)]
    want = bn.banded_nw_fwd_plain(*args, gp, match, mismatch, W)
    for x, y in zip(got, want):
        assert np.array_equal(x.view(np.uint8) if x.dtype == np.float32
                              else x, y.numpy().view(np.uint8)
                              if y.dtype == torch.float32 else y.numpy())
    tb, mlast, dlb = (torch.from_numpy(x) for x in got)
    scores, _, _, ops = bn.banded_nw_chase(tb, mlast, dlb, *args[2:], gp)
    paths = bn.decode_packed_ops(ops.numpy(), len(pairs))
    for k, pair in enumerate(pairs):
        if len(pair) >= 4:
            s_o, p_o = banded_nw(pair[0], pair[1], pair[2], pair[3], ap)
        else:
            s_o, p_o = banded_nw_main_diag(pair[0], pair[1], radius, ap)
        assert np.float32(s_o) == scores[k].item() and p_o == paths[k], k


@pytest.mark.parametrize("pen", [DYADIC, NON_DYADIC])
@pytest.mark.parametrize("bw", [1, 16, 32, 33, 64, 120, 121, 126])
def test_schedule_model_at_band(bw, pen):
    """The kernel's schedule at the cells its rule takes for each band,
    la > lb, la < lb and la == lb."""
    rng = np.random.default_rng(bw)
    n = 3 if bw == 1 else 6
    assert_model_matches(band_pairs(rng, n, bw), 0, nucleo_params(*pen))


@pytest.mark.parametrize("cells", (4, 6))
def test_schedule_model_every_cells(cells):
    """Both part widths the kernel is built for, at bands that leave the
    last lane's cells partly past the band (33) and at 64."""
    rng = np.random.default_rng(40 + cells)
    pairs = band_pairs(rng, 4, 33) + band_pairs(rng, 3, 64)
    assert_model_matches(pairs, 0, nucleo_params(*NON_DYADIC), cells)


@pytest.mark.parametrize("pen", [DYADIC, NON_DYADIC])
def test_schedule_model_indel_fixture(pen):
    """The fixture on which the TPU kernel's doubling scan departs from
    the oracle, and random main-diagonal pairs with N letters."""
    pairs = indel_fixture(n=16)
    assert_model_matches(pairs, 24, nucleo_params(*pen))
    rng = np.random.default_rng(9)
    assert_model_matches(rand_pairs(rng, 8, 20, 120, dl=12, n_rate=0.05,
                                    lower=0.2), 16, nucleo_params(*pen))


def test_fwd_cells_rule():
    """The kernel's cells either side of its threshold, and the geometry
    every band up to BAND_LANES gets."""
    assert [kernel_cells(w) for w in (1, 41, 120, 121, 125, 126)] == \
        [6, 6, 6, 4, 4, 4]
    for w in range(1, bn.BAND_LANES + 1):
        lanes, pairs, ring = fwd_geometry(w, kernel_cells(w))
        assert 2 * lanes * kernel_cells(w) >= w and lanes * pairs <= 32
        assert ring >= FLUSH_ROWS + lanes - 1
        assert ring % FLUSH_ROWS == 0


# banded_nw_chase's kernel constants, read from its source like the ones
# above: windows a ring, the most bytes of a slot and of a warp's rings,
# the fewest warps a launch is cut into, the most shared memory a block
CHASE = {k: int(eval(re.search(rf"#define BNC_{k} ([\d ()*]+)\n", _CU)[1]))
         for k in ("SLOTS", "SLOT_MAX", "RING_WARP", "MIN_WARPS",
                   "SMEM_MAX")}


def _next_state(st, bits):
    if st == bn.OP_M:
        return bn.OP_D if bits & bn.TB_DM else (
            bn.OP_I if bits & bn.TB_IM else bn.OP_M)
    if st == bn.OP_D:
        return bn.OP_M if bits & bn.TB_MD else bn.OP_D
    return bn.OP_M if bits & bn.TB_MI else bn.OP_I


# the kernel's 2-bit tables of the next state, by state and bits
_TABLES = {bn.OP_M: 0x64646464, bn.OP_D: 0x00550055, bn.OP_I: 0x0000aaaa}
NEXT = {st: [(t >> (2 * b)) & 3 for b in range(16)]
        for st, t in _TABLES.items()}
assert all(NEXT[st][b] == _next_state(st, b) for st in NEXT
           for b in range(16))


def chase_geometry(P, W, stride, with_tb, min_warps=None):
    """(pairs a warp G, rows a window R, bytes a slot, shared memory a
    block: the slots' mbarriers, the rings, the scratch area) of
    banded_nw_chase's kernel (csrc/banded_nw.cu
    banded_nw_chase_geometry); None where one pair does not fit."""
    min_warps = CHASE["MIN_WARPS"] if min_warps is None else min_warps
    RB, S = W + 1, CHASE["SLOTS"]
    G = 32
    while G >= 1:
        if G == 1 or -(-P // G) >= min_warps:
            R = slot = 0
            if with_tb:
                room = min(CHASE["RING_WARP"] // (S * G),
                           CHASE["SLOT_MAX"]) & ~15
                R = max(2, (room - 15) // RB)
                slot = (R * RB + 30) & ~15
            scratch = G * W * 5
            if with_tb:
                scratch = max(scratch, G * stride)
            head = (G * S * 8 + 15) & ~15 if with_tb else 0
            smem = head + G * S * slot + ((scratch + 15) & ~15)
            if smem <= CHASE["SMEM_MAX"]:
                return G, R, slot, smem
        G //= 2
    return None


def chase_window_model(tb, mlast, dlb, la, lb, dlo, bw, gp, stride,
                       min_warps=None):
    """banded_nw_chase's kernel (csrc/banded_nw.cu), warp by warp and lane
    by lane: G pairs a warp; each pair's windows of R rows copied top down
    into a ring of SLOTS slots, one copy a window from the 16-byte
    boundary at or below its first byte, rounded up to 16 bytes but not
    past tb's last 16-byte boundary, the bytes beyond that one by one;
    window e + SLOTS - 1 issued into the slot of window e - 1 at the start
    of epoch e; every lane chases in window e until it needs a row below
    it, inside the matrix by the kernel's fixed steps of the band cell and
    the row's address (asserted against their direct computation) and the
    next state from its 2-bit tables.  Asserts that every byte a lane
    reads is in the slot of the
    window of its epoch, which holds that window, inside the bytes copied
    for it, and is the traceback byte the chase wants.  tb None: the
    final row only.  Returns (scores, states, tblast, ops) as numpy
    arrays."""
    f32 = np.float32
    P, W = mlast.shape
    RB, S = W + 1, CHASE["SLOTS"]
    with_tb = tb is not None
    G, R, slot, _ = chase_geometry(P, W, stride, with_tb, min_warps)
    la, lb, dlo, bw = (np.asarray(x, np.int64) for x in (la, lb, dlo, bw))
    r_open_a, r_ext_a = f32(gp[6]), f32(gp[10])
    amax = tb.shape[1] if with_tb else 0
    flat = tb.reshape(-1) if with_tb else None
    ml, dl = np.asarray(mlast, f32), np.asarray(dlb, f32)
    scores = np.full(P, np.nan, f32)
    states = np.full(P, 0xEE, np.uint8)
    tblast = np.full((P, W), 0xEE, np.uint8)
    ops = np.full((P, stride), 0xEE, np.uint8)
    neg = f32(bn.NEG)
    for p0 in range(0, P, G):
        n_live = min(G, P - p0)
        ring = np.full(G * S * slot, 0xEE, np.uint8)
        held = {}                     # (g, slot index) -> (window, bytes)

        def issue(e):
            for g in range(n_live):
                hi = int(la[p0 + g]) - 1 - e * R
                if hi < 0:
                    continue
                lo = max(0, hi - R + 1)
                gs = ((p0 + g) * amax + lo) * RB
                ga = gs & ~15
                want = (gs - ga) + (hi - lo + 1) * RB
                n_bulk = min((want + 15) & ~15, (flat.size - ga) & ~15)
                assert n_bulk % 16 == 0 and max(n_bulk, want) <= slot
                dst = (g * S + e % S) * slot
                ring[dst:dst + slot] = 0xEE
                # the bulk copy, then the bytes past its end singly
                ring[dst:dst + n_bulk] = flat[ga:ga + n_bulk]
                ring[dst + n_bulk:dst + want] = flat[ga + n_bulk:ga + want]
                held[(g, e % S)] = (e, max(n_bulk, want))

        if with_tb:
            for e in range(S - 1):
                issue(e)
        jstar = np.full(n_live, -1)
        st = np.zeros(n_live, np.int64)
        for g in range(n_live):
            p = p0 + g
            i1 = neg
            n_last = lb[p] - dlo[p] + 1
            for k in range(W):
                bit = 0
                if k < n_last:
                    mi = (neg if k == 0 else ml[p, k - 1]) + r_open_a
                    i1 = f32(i1 + r_ext_a)
                    if mi > i1:
                        i1, bit, jstar[g] = mi, bn.TB_MI, dlo[p] - 1 + k
                tblast[p, k] = bit
            score = ml[p, lb[p] - dlo[p]]
            if dl[p] > score:
                score, st[g] = dl[p], bn.OP_D
            if i1 > score:
                score, st[g] = i1, bn.OP_I
            scores[p], states[p] = score, st[g]
        if not with_tb:
            continue
        codes = [[] for _ in range(n_live)]
        pos = [(int(la[p0 + g]), int(lb[p0 + g])) for g in range(n_live)]

        def alive(g):
            i, j = pos[g]
            return (i > 0 or j > 0) and i >= 0 and j >= 0 and \
                len(codes[g]) < 4 * stride

        e = 0
        while True:
            issue(e + S - 1)
            for g in range(n_live):
                p = p0 + g
                hi = int(la[p]) - 1 - e * R
                lo = max(0, hi - R + 1)
                gs = (p * amax + lo) * RB
                base = (g * S + e % S) * slot
                sb = base + (gs & 15) - lo * RB
                def read(ri, addr, k):
                    """The byte at shared address addr, row ri, cell k."""
                    win, n_bytes = held[(g, e % S)]
                    assert win == e and lo <= ri <= hi
                    assert base <= addr < base + n_bytes
                    assert ring[addr] == flat[(p * amax + ri) * RB + k]
                    return int(ring[addr])

                while alive(g):
                    i, j = pos[g]
                    if lo < i < la[p] and 0 < j < lb[p]:
                        # the kernel's interior loop: k and the row's
                        # address move by fixed steps
                        k = j - i + la[p] - dlo[p]
                        row = sb + i * RB
                        while True:
                            s_ = st[g]
                            codes[g].append(s_)
                            sd, si = s_ == bn.OP_D, s_ == bn.OP_I
                            k += 1 if sd else (-1 if si else 0)
                            row -= 0 if si else RB
                            i -= not si
                            j -= not sd
                            # (i, j) is the landing cell now
                            assert k == j - (dlo[p] + i - la[p])
                            assert row == sb + i * RB
                            if 0 <= k < bw[p]:
                                bits = read(i, row + k, k)
                            else:
                                bits = bn.TB_IM if k == -1 else 0
                            st[g] = NEXT[s_][bits]
                            pos[g] = (i, j)
                            if not (lo < i < la[p] and 0 < j < lb[p]
                                    and len(codes[g]) < 4 * stride):
                                break
                        continue
                    s_ = st[g]
                    ri = i if s_ == bn.OP_I else i - 1
                    rj = j if s_ == bn.OP_D else j - 1
                    in_tb = ri >= 0 and rj >= 0 and ri < la[p]
                    if in_tb and ri < lo:
                        assert ri == lo - 1
                        break
                    codes[g].append(s_)
                    bits = 0
                    if in_tb:
                        k = rj - (dlo[p] + ri - la[p])
                        if rj == lb[p]:
                            bits = read(ri, sb + ri * RB + W, W)
                        elif k == -1:
                            bits = bn.TB_IM
                        elif 0 <= k < bw[p]:
                            bits = read(ri, sb + ri * RB + k, k)
                    elif ri == la[p] and rj >= 0:
                        assert s_ == bn.OP_I
                        bits = bn.TB_MI if rj == jstar[g] else 0
                    st[g] = NEXT[s_][bits]
                    pos[g] = (ri, rj)
            if not any(alive(g) for g in range(n_live)):
                break
            e += 1
        for g in range(n_live):
            c = np.full(4 * stride, bn.OP_PAD, np.uint8)
            c[:len(codes[g])] = codes[g]
            ops[p0 + g] = c[0::4] | (c[1::4] << 2) | (c[2::4] << 4) | \
                (c[3::4] << 6)
    return scores, states, tblast, (ops if with_tb else None)


def assert_chase_model_matches(pairs, radius, ap, min_warps=None):
    """The chase model's outputs bit-equal to banded_nw_chase_plain's,
    with and without the traceback."""
    batch = bn.pack_pairs(pairs, True, radius)
    gp = gap_params(ap)
    args = [torch.from_numpy(x) for x in (batch.a_let, batch.b_let, batch.la,
                                         batch.lb, batch.dlo, batch.bw)]
    tb, mlast, dlb = bn.banded_nw_fwd(*args, gp, *bn.match_mismatch(ap))
    stride = (int((batch.la + batch.lb).max()) + 3) // 4
    for t in (tb, None):
        want = bn.banded_nw_chase_plain(t, mlast, dlb, *args[2:], gp, stride)
        got = chase_window_model(None if t is None else t.numpy(),
                                 mlast.numpy(), dlb.numpy(), batch.la,
                                 batch.lb, batch.dlo, batch.bw, gp.numpy(),
                                 stride, min_warps)
        for name, x, y in zip(("scores", "states", "tblast", "ops"), got,
                              want):
            if y is None:
                assert x is None
                continue
            y = y.numpy()
            if y.dtype == np.float32:
                x, y = x.view(np.uint32), y.view(np.uint32)
            assert np.array_equal(x, y), name


@pytest.mark.parametrize("bw", [1, 2, 33, 64, 125, 126])
def test_chase_model_at_band(bw):
    """Windows of every width the geometry gives, 32 pairs a warp (a
    second warp part full), pairs of different la in one warp, la > lb,
    la < lb and la == lb, a window that ends at tb's last byte."""
    rng = np.random.default_rng(100 + bw)
    pairs = band_pairs(rng, 37, bw, lmin=max(bw, 2), lmax=160)
    # the longest last: its top window ends at tb's last byte
    pairs.sort(key=lambda x: len(x[0]))
    assert_chase_model_matches(pairs, 0, nucleo_params(*NON_DYADIC),
                               min_warps=1)


@pytest.mark.parametrize("pen", [DYADIC, NON_DYADIC])
def test_chase_model_lopsided(pen):
    """Main-diagonal bands of pairs much longer on one side (long final-row
    and Drow[LB] runs), N letters, one pair a warp and 32."""
    rng = np.random.default_rng(21)
    pairs = rand_pairs(rng, 12, 20, 120, dl=12, n_rate=0.05, lower=0.2)
    pairs += [(a[:max(1, len(a) // 3)], b) for a, b in pairs[:4]]
    pairs += [(a, b[:max(1, len(b) // 3)]) for a, b in pairs[4:8]]
    for min_warps in (None, 1):
        assert_chase_model_matches(pairs, 20, nucleo_params(*pen), min_warps)


def test_chase_geometry():
    """The launch geometry at phase 4's shapes and at the limits: every
    window fits its slot, a block's shared memory stays in bounds, and
    a launch has BNC_MIN_WARPS warps wherever pairs a warp can halve."""
    assert chase_geometry(65536, 33, 65, True)[:3] == (32, 14, 496)
    assert chase_geometry(2048, 125, 500, True)[:3] == (2, 32, 4048)
    assert chase_geometry(1, 126, 10, True)[0] == 1
    for W in (1, 2, 33, 125, 126):
        for P in (1, 100, 2048, 65536):
            for with_tb in (True, False):
                G, R, slot, smem = chase_geometry(P, W, 64, with_tb)
                assert smem <= CHASE["SMEM_MAX"]
                assert G == 1 or -(-P // G) >= CHASE["MIN_WARPS"]
                if with_tb:
                    assert R >= 2 and slot % 16 == 0
                    assert -(-(15 + R * (W + 1)) // 16) * 16 <= slot
    # paths up to the shared memory's limit
    assert chase_geometry(1, 126, 150000, True) is not None
    assert chase_geometry(1, 126, 200000, True) is None
