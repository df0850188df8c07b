"""usearch12_tpu_torch banded NW (ops/wavefront_nw.py, ops/wavefront_trace.py)
on the CPU, where the wrappers run their plain PyTorch versions, against
the JAX package's judges: align/oracle.py:banded_nw_main_diag and the
host C kernel nw_band.  Tolerance 0: scores equal as float32, paths equal
as strings, traceback bits equal cell by cell."""

import ctypes

import numpy as np
import pytest
import torch

from usearch12_tpu.align.oracle import band_diag_range, banded_nw_main_diag, \
    get_range_j
from usearch12_tpu.native import GapParams, get_lib
from usearch12_tpu.ops.banded_nw import NEG as JAX_NEG, _letters
from usearch12_tpu.ops.wavefront_nw import WavefrontNWDevice
from usearch12_tpu_torch.ops import wavefront_nw as wnw
from usearch12_tpu_torch.ops import wavefront_trace as wtr
from usearch12_tpu_torch.ops.wavefront_nw import (BW_MAX, TorchWaveAligner,
                                                  gap_params,
                                                  native_nw_band,
                                                  nucleo_params)

CPU = torch.device("cpu")
CONV = np.frombuffer(b"ACGTN", np.uint8)


def rand_pairs(rng, n, lmin, lmax, dl=0, n_rate=0.0):
    """n pairs: b is a with ~10% substitutions, cut or extended by up to
    dl letters; a fraction n_rate of a's letters are N."""
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
        pairs.append((CONV[a], CONV[b]))
    return pairs


def assert_matches_oracle(pairs, radius, ap, **kw):
    scores, paths = TorchWaveAligner(ap, CPU, **kw).align(pairs, radius)
    assert scores.dtype == np.float32 and len(paths) == len(pairs)
    for k, (a, b) in enumerate(pairs):
        s_o, p_o = banded_nw_main_diag(a, b, radius, ap)
        assert np.float32(s_o) == scores[k], (k, len(a), len(b))
        assert p_o == paths[k], (k, len(a), len(b))
    s_n, p_n = native_nw_band(pairs, radius, ap)
    assert np.array_equal(s_n, scores) and p_n == paths


def default_ap():
    return nucleo_params(-10.0, -1.0, -0.5, -0.5)


def test_constants_and_letters_match_jax():
    assert np.float32(wnw.NEG) == JAX_NEG
    allb = np.arange(256, dtype=np.uint8)
    assert np.array_equal(wnw.letters(allb), _letters(allb, True))


@pytest.mark.parametrize("cls", range(16))
def test_gap_params_match_jax(cls):
    base = nucleo_params(-10.3, -1.1, -0.7, -0.4)
    ap = base.hole_params(bool(cls & 1), bool(cls & 2), bool(cls & 4),
                          bool(cls & 8))
    gp = gap_params(ap)
    assert gp.dtype == torch.float32 and gp.shape == (16,)
    assert np.array_equal(gp.numpy(), WavefrontNWDevice(ap).gp[0])
    dev = WavefrontNWDevice(ap)
    assert wnw.match_mismatch(ap) == (dev.match, dev.mismatch)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_pairs(seed):
    rng = np.random.default_rng(seed)
    assert_matches_oracle(rand_pairs(rng, 8, 20, 120, n_rate=0.05), 16,
                          default_ap())


@pytest.mark.parametrize("seed", [4, 5])
def test_asymmetric_lengths(seed):
    rng = np.random.default_rng(seed)
    pairs = rand_pairs(rng, 10, 1, 70, dl=25)
    pairs += [(CONV[rng.integers(0, 4, 1)], CONV[rng.integers(0, 4, 30)]),
              (CONV[rng.integers(0, 4, 30)], CONV[rng.integers(0, 4, 1)])]
    for radius in (0, 3, 16):
        assert_matches_oracle(pairs, radius, default_ap())


@pytest.mark.parametrize("radius", [1, 3, 7, 15])
def test_band_edge_odd_band_width(radius):
    """la == lb and odd radius: odd band width and (la - dlo) odd; the
    optimal path opens with `radius` insertions and rides D* == dhi."""
    rng = np.random.default_rng(radius)
    core = CONV[rng.integers(0, 4, 60)]
    a = np.concatenate([core, CONV[rng.integers(0, 4, radius)]])
    b = np.concatenate([CONV[rng.integers(0, 4, radius)], core])
    dlo, dhi = band_diag_range(len(a), len(b), radius)
    assert (dhi - dlo + 1) % 2 == 1 and (len(a) - dlo) % 2 == 1
    _, path = banded_nw_main_diag(a, b, radius, default_ap())
    assert path.startswith("I" * radius)
    assert_matches_oracle([(a, b)], radius, default_ap())


def test_nondyadic_penalties():
    rng = np.random.default_rng(23)
    ap = nucleo_params(-10.3, -1.1, -0.7, -0.4)
    assert_matches_oracle(rand_pairs(rng, 10, 20, 120, dl=6), 16, ap)


@pytest.mark.parametrize("cls", range(16))
def test_hole_terminal_classes(cls):
    rng = np.random.default_rng(100 + cls)
    ap = nucleo_params(-10.3, -1.1, -0.7, -0.4).hole_params(
        bool(cls & 1), bool(cls & 2), bool(cls & 4), bool(cls & 8))
    assert_matches_oracle(rand_pairs(rng, 6, 10, 80, dl=8), 8, ap)


def test_bands_up_to_bw_max():
    """The widest band the kernel takes (BW_MAX) against nw_band, and one
    wider raises."""
    rng = np.random.default_rng(8)
    ap = default_ap()
    radius = (BW_MAX - 1) // 2
    la = radius + 80
    pairs = rand_pairs(rng, 2, la, la + 1)
    dlo, dhi = band_diag_range(la, la, radius)
    assert dhi - dlo + 1 == BW_MAX
    scores, paths = TorchWaveAligner(ap, CPU).align(pairs, radius)
    s_n, p_n = native_nw_band(pairs, radius, ap)
    assert np.array_equal(s_n, scores) and p_n == paths
    with pytest.raises(ValueError):
        TorchWaveAligner(ap, CPU).align(pairs, radius + 1)


def test_launch_split_by_traceback_budget():
    rng = np.random.default_rng(9)
    pairs = rand_pairs(rng, 12, 20, 90, dl=5)
    ap = default_ap()
    one = TorchWaveAligner(ap, CPU).align(pairs, 16)
    split = TorchWaveAligner(ap, CPU, tb_budget=1500).align(pairs, 16)
    assert np.array_equal(one[0], split[0]) and one[1] == split[1]
    assert_matches_oracle(pairs, 16, ap, tb_budget=1)


def _native_forward(a, b, radius, ap):
    """nw_band's traceback bytes, M row and Drow after the forward DP."""
    la, lb = len(a), len(b)
    dlo, dhi = band_diag_range(la, lb, radius)
    tb = np.zeros((la + 1) * (lb + 1), np.uint8)
    mrow = np.zeros(lb + 2, np.float32)
    drow = np.zeros(lb + 1, np.float32)
    path = ctypes.create_string_buffer(la + lb + 2)
    score = ctypes.c_float(0)
    n = get_lib().nw_band(a, la, b, lb, dlo, dhi,
                          ctypes.byref(GapParams.from_alnparams(ap)),
                          np.ascontiguousarray(ap.subst_mx, np.float32), tb,
                          mrow, drow, path, ctypes.byref(score))
    assert n > 0
    bw = dhi - dlo + 1
    banded = bw + 2 <= lb + 1
    stride = bw + 2 if banded else lb + 1

    def bits(i, j):
        if j == lb:
            return tb[stride * i + (bw + 1 if banded else lb)]
        s = get_range_j(la, lb, dlo, dhi, i)[0]
        return tb[stride * i + (j - s + 1 if banded else j)]
    return bits, mrow[1:], drow[lb], dlo, bw


def _assert_forward_matches_native(pairs, radius, ap):
    """wavefront_fwd alone on `pairs`: every band cell's traceback
    nibble, the Drow[LB] column, the last M row and Drow[LB] at (la, lb)
    equal the host C kernel's."""
    la, lb, dlo, bw = wnw.pair_geometry(pairs, radius)
    w = wnw.pack_launch(pairs, la, lb, dlo, bw, CPU)
    tb, mlast, dlb = wnw.wavefront_fwd(*w, gap_params(ap),
                                       *wnw.match_mismatch(ap))
    tb = tb.numpy()
    for p, (a, b) in enumerate(pairs):
        nbits, mrow, drow_lb, dlo_p, bw_p = _native_forward(a, b, radius, ap)
        nb = ((bw_p + 1) // 2 + 1) // 2
        base = int(w.tb_off[p])

        def port_bits(i, j):
            k = len(a) - i + j - dlo_p
            byte = tb[base + (i + j) * nb + (k >> 2)]
            return (byte >> (4 * ((k >> 1) & 1))) & 15
        for i in range(len(a)):
            s, e = get_range_j(len(a), len(b), dlo_p, dlo_p + bw_p - 1, i)
            for j in range(s, e):
                assert port_bits(i, j) == nbits(i, j), (p, i, j)
                if i == len(a) - 1:
                    assert mlast[p, j].item() == mrow[j]
            if (len(a) - i + len(b) - dlo_p) // 2 < (bw_p + 1) // 2:
                assert port_bits(i, len(b)) == nbits(i, len(b)), (p, i)
        assert dlb[p].item() == drow_lb


@pytest.mark.parametrize("seed", [11, 12])
def test_forward_bits_match_native(seed):
    rng = np.random.default_rng(seed)
    ap = nucleo_params(-10.3, -1.1, -0.7, -0.4).hole_params(
        True, False, False, True)
    _assert_forward_matches_native(rand_pairs(rng, 5, 10, 60, dl=10), 5, ap)


@pytest.mark.parametrize("radius", [0, 15, 31, 32, 63, 64])
def test_forward_bits_match_native_at_launch_widths(radius):
    """Bands of one and of two or three warps of lanes on the card (a
    warp holds 32 lanes, a band up to 63), around their border steps;
    the traceback ranges are packed back to back."""
    rng = np.random.default_rng(40 + radius)
    ap = nucleo_params(-10.3, -1.1, -0.7, -0.4)
    pairs = rand_pairs(rng, 5, 1, 2 * radius + 40, dl=radius + 3)
    la, lb, dlo, bw = wnw.pair_geometry(pairs, radius)
    w = wnw.pack_launch(pairs, la, lb, dlo, bw, CPU)
    nbytes = wtr.tb_nbytes(la, lb, bw)
    assert w.tb_bytes == nbytes.sum() and int(w.tb_off[0]) == 0
    assert np.array_equal(w.tb_off[1:].numpy(), np.cumsum(nbytes)[:-1])
    _assert_forward_matches_native(pairs, radius, ap)


def test_wrappers_reject_other_devices_and_bad_inputs():
    rng = np.random.default_rng(1)
    pairs = rand_pairs(rng, 2, 10, 20)
    w = wnw.pack_launch(pairs, *wnw.pair_geometry(pairs, 4), CPU)
    gp = gap_params(default_ap())
    meta = wnw.WaveLaunch(*(x.to("meta") for x in w[:7]), w.tb_bytes)
    with pytest.raises(ValueError):
        wnw.wavefront_fwd(*meta, gp.to("meta"), 1.0, -2.0)
    with pytest.raises(ValueError):
        wnw.wavefront_fwd(w.a_let.to(torch.int32), *w[1:], gp, 1.0, -2.0)
    with pytest.raises(ValueError):      # traceback buffer too small
        wnw.wavefront_fwd(*w[:7], w.tb_bytes - 1, gp, 1.0, -2.0)
    with pytest.raises(ValueError):      # letter rows shorter than lb
        wnw.wavefront_fwd(w.a_let, w.b_let[:, :5].contiguous(), *w[2:], gp,
                          1.0, -2.0)
    tb, mlast, dlb = wnw.wavefront_fwd(*w, gp, 1.0, -2.0)
    with pytest.raises(ValueError):      # mlast narrower than lb
        wtr.wavefront_trace(tb, w.tb_off, mlast[:, :5].contiguous(), dlb,
                            w.la, w.lb, w.dlo, w.bw, gp)
    with pytest.raises(ValueError):
        TorchWaveAligner(default_ap(), CPU).align(pairs, 4, nucleo=False)
    assert wnw.wavefront_fwd.launches == 0


@pytest.mark.parametrize("pairs,total,longest,warp", [
    (18549, 5509487, 2208, True),     # long-read amplicons, mixed lengths
    (2308, 8000000, 3700, True),      # the long-contig slice's largest
    (65536, 65536 * 500, 520, False),  # many short pairs of one length
    (16384, 16384 * 2000, 2040, False),
])
def test_trace_kernel_choice_reads_the_load(pairs, total, longest, warp):
    """The warp kernel while a launch's summed steps stay under
    WARP_MAX_LOAD times its longest pair's, whatever its pair count; the
    thread kernel above."""
    assert wtr.takes_warp_kernel(total, longest) is warp
    assert wtr.takes_warp_kernel(wtr.WARP_MAX_LOAD * longest - 1, longest)
    assert not wtr.takes_warp_kernel(wtr.WARP_MAX_LOAD * longest, longest)


@pytest.mark.parametrize("cls", [0, 5, 15])
def test_state_converts_jax_aln_params(cls):
    """The JAX package's AlnParams reach the port through state.py as the
    port's own, field for field, and align as the oracle does."""
    from usearch12_tpu.scoring import AlnParams as JaxAlnParams
    from usearch12_tpu.scoring import nuc_mx as jax_nuc_mx
    from usearch12_tpu_torch import state
    from usearch12_tpu_torch.scoring import AlnParams
    jap = JaxAlnParams(nucleo=True, subst_mx=jax_nuc_mx(1.0, -2.0))
    jap.init4(-10.3, -1.1, -0.7, -0.4)
    jap = jap.hole_params(bool(cls & 1), bool(cls & 2), bool(cls & 4),
                          bool(cls & 8))
    ap = state.aln_params(jap)
    assert isinstance(ap, AlnParams) and ap.nucleo
    for name in state.PENALTIES:
        assert getattr(ap, name) == getattr(jap, name), name
    assert np.array_equal(ap.subst_mx, jap.subst_mx)
    assert ap.subst_mx is not jap.subst_mx
    rng = np.random.default_rng(60 + cls)
    assert_matches_oracle(rand_pairs(rng, 4, 20, 80, dl=5), 8, ap)
