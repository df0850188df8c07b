"""usearch12_tpu_torch's BandedNWDevice against the JAX package's
BandedNWDevice, whose Pallas kernel (ops/banded_nw.py:_make_kernel) runs
in interpret mode on the CPU as tests/test_pallas_nw.py runs it.  The
port runs its plain PyTorch versions.  Every case keeps amax at 128 and
8 pairs per block, so the JAX package compiles its kernel once."""

import numpy as np
import pytest
import torch

from usearch12_tpu.align.oracle import banded_nw_main_diag
from usearch12_tpu.ops import banded_nw as jax_bnw
from usearch12_tpu_torch.ops import banded_nw as bn
from usearch12_tpu_torch.ops.wavefront_nw import nucleo_params

from test_torch_banded_nw import DYADIC, NON_DYADIC, indel_fixture

CPU = torch.device("cpu")
RADIUS = 24


@pytest.fixture(scope="module")
def pairs():
    return indel_fixture()


def test_dyadic_equals_pallas_cell_by_cell(pairs):
    """Scores, final states, every band cell's traceback nibble, the
    Drow[LB] bits, the final DPI row and the paths."""
    ap = nucleo_params(*DYADIC)
    jdev = jax_bnw.BandedNWDevice(ap, pb=8)
    jbatch = jax_bnw.pack_pairs(pairs, True, RADIUS)
    assert jbatch.amax == 128
    s_j, st_j, tb_j, tl_j = jdev.run_batch(jbatch)
    dev = bn.BandedNWDevice(ap, CPU)
    batch = bn.pack_pairs(pairs, True, RADIUS)
    s, st, tb, tl = dev.run_batch(batch)
    assert np.array_equal(s, s_j) and np.array_equal(st, st_j)
    W = tl.shape[1]
    assert np.array_equal(tl, np.asarray(tl_j)[:, :W])
    assert not np.asarray(tl_j)[:, W:].any()
    n_cells = 0
    for p in range(len(pairs)):
        la, lb = int(batch.la[p]), int(batch.lb[p])
        dlo, bw = int(batch.dlo[p]), int(batch.bw[p])
        i, k = np.meshgrid(np.arange(la), np.arange(bw), indexing="ij")
        j = dlo + i - la + k
        ok = (j >= 0) & (j < lb)
        theirs = tb_j[p][i, (k + i) % 128]
        assert np.array_equal(tb[p, :la, :bw][ok], theirs[ok]), p
        n_cells += int(ok.sum())
        rows = np.arange(la)
        stored = la + lb - dlo - rows < 128      # Drow[LB] lanes kept
        assert np.array_equal(tb[p, :la, W][stored],
                              tb_j[p][rows[stored], (la + lb - dlo) % 128])
    assert n_cells > 100000
    paths = dev.traceback(batch, st, tb, tl)
    s_jd, p_jd = jdev.align_device(pairs, RADIUS)
    s_d, p_d = dev.align_device(pairs, RADIUS)
    assert np.array_equal(s_d, s_jd) and p_d == p_jd == paths


def test_non_dyadic_port_equals_oracle_where_pallas_does_not(pairs):
    """With init4(-10.3, -1.1, -0.7, -0.4) the Pallas kernel's doubling
    scan adds the extension penalty in another order than the oracle, and
    its scores or paths depart from the oracle's on some pairs; the port
    stays equal to the oracle on all of them."""
    ap = nucleo_params(*NON_DYADIC)
    s_j, p_j = jax_bnw.BandedNWDevice(ap, pb=8).align(pairs, RADIUS)
    s, p = bn.BandedNWDevice(ap, CPU).align(pairs, RADIUS)
    pallas_off = 0
    for k, (a, b) in enumerate(pairs):
        s_o, p_o = banded_nw_main_diag(a, b, RADIUS, ap)
        assert np.float32(s_o) == s[k] and p_o == p[k], k
        pallas_off += not (np.float32(s_o) == s_j[k] and p_o == p_j[k])
    assert pallas_off >= 1
