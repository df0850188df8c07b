"""The card path's SINTAX tie-break draws on the CPU: the C runtime's
sintax_grand_draws_c against GlobalRand.randu32 draw for draw and state
for state, call after call and after restart_rng(); and
SintaxTorchClassifier._prepare with the library absent (the Python loop)
against the same with it, with only the native calls counted."""

import numpy as np
import pytest
import torch

import usearch12_tpu_torch.native as native
from tests.test_torch_sintax_resident import _argv, _data
from usearch12_tpu_torch.amplicon.sintax import WINDOW, GlobalRand, SintaxRun
from usearch12_tpu_torch.cli import parse_argv
from usearch12_tpu_torch.io.fastx import read_fastx

CPU = torch.device("cpu")


@pytest.mark.parametrize("counts", [(0,), (1,), (100,), (102_400,),
                                    (100, 1, 3_000)])
@pytest.mark.parametrize("seed", [1, 3, 2**31 + 12_345, 2**32 - 1])
def test_native_draws_equal_global_rand(seed, counts):
    lib = native.get_lib()
    assert lib is not None
    grand = GlobalRand(seed)
    gx = np.array(grand.x, np.uint64)
    for n in counts:
        got = np.empty(n, np.uint32)
        lib.sintax_grand_draws_c(gx.ctypes.data, got.ctypes.data, n)
        want = np.array([grand.randu32() for _ in range(n)], np.uint32)
        assert np.array_equal(got, want)
        assert gx.tolist() == grand.x


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _data(tmp_path_factory.mktemp("draws"), 11, n_q=300)


def _window(q):
    return [s for _, s, _ in read_fastx(q)][:WINDOW]


def test_restart_rng_starts_the_stream_again(files):
    db, q1, _ = files
    parse_argv(_argv(db, "-sintax_device"))
    run = SintaxRun(CPU)
    dev, seqs = run.dev_cls, _window(q1)
    _, jobs, (*_, first) = dev._prepare(seqs, True)
    second = dev._prepare(seqs, True)[2][4]
    nj = len(jobs)
    assert nj > 100 and not np.array_equal(first[:nj], second[:nj])
    run.cls.restart_rng()
    again = dev._prepare(seqs, True)[2][4]
    assert np.array_equal(again, first)
    assert not again[nj:].any()         # the chunks' padding draws nothing
    want = GlobalRand(3)
    for _ in range(nj * run.cls.boots):
        want.randu32()
    assert run.cls.grand.x == want.x
    assert dev.stats["sintax_draws_native"] == 3


@pytest.mark.parametrize("both", [True, False])
def test_prepare_without_the_library_gives_the_same_arrays(files, both,
                                                           monkeypatch):
    db, q1, _ = files
    parse_argv(_argv(db, "-sintax_device"))
    run = SintaxRun(CPU)
    dev, seqs = run.dev_cls, _window(q1)
    run.cls.restart_rng()
    per_q, jobs, arrays = dev._prepare(seqs, both)
    x_native = list(run.cls.grand.x)
    assert dev.stats["sintax_draws_native"] == 1
    run.cls.restart_rng()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    per_q2, jobs2, arrays2 = dev._prepare(seqs, both)
    assert run.cls.grand.x == x_native
    assert dev.stats["sintax_draws_native"] == 1
    assert per_q2 == per_q and len(jobs2) == len(jobs) > 0
    for a, b in zip(arrays2, arrays):
        assert a.dtype == b.dtype and np.array_equal(a, b)
