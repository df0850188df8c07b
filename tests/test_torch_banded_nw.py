"""usearch12_tpu_torch's row-sweep banded NW (ops/banded_nw.py) on the CPU,
where BandedNWDevice's kernels run their plain PyTorch versions, against
the JAX package's judges: align/oracle.py:banded_nw and the host C kernel
nw_band.  Tolerance 0: scores equal as float32, paths equal as strings."""

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
    assert tb2 is None and tb1.shape == (batch.la.max(), batch.bw.max() + 1,
                                         len(pairs))
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
