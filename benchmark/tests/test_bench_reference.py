"""The plain reference against the port at small sizes: the banded DP
against the port's oracle, the database mask against the port's mask,
the UDBSearchBig ranking against the port's CSR ranker.  (The reference
itself imports nothing of the port; these tests may.)"""

import numpy as np
import pytest

from benchmark import gen
from benchmark.generators import otus, subs
from benchmark.reference import dp, rank

ACGT = gen.ACGT


def _mutate(rng, s, rate):
    out = []
    for c in s:
        r = rng.random()
        if r < rate / 3:
            continue
        out.append(c)
        if r < 2 * rate / 3:
            out.append(ACGT[rng.integers(4)])
        elif r < rate:
            out[-1] = ACGT[rng.integers(4)]
    return np.array(out or [ACGT[0]], np.uint8)


@pytest.mark.parametrize("seed", range(4))
def test_dp_equals_the_port_oracle(seed):
    from usearch12_tpu_torch.align import oracle
    from usearch12_tpu_torch.ops.wavefront_nw import nucleo_params
    rng = np.random.default_rng(seed)
    for _ in range(15):
        a = ACGT[rng.integers(0, 4, int(rng.integers(5, 150)))]
        b = _mutate(rng, a, float(rng.choice([0.05, 0.3, 0.8])))
        if rng.random() < 0.3:
            b = np.char.lower(b.view("S1")).view(np.uint8)   # masked
        radius = int(rng.integers(1, 40))
        term = tuple(bool(x) for x in rng.integers(0, 2, 4))
        pen = dp.penalties(1.0, -2.0, -10.0, -1.0, -0.5, -0.5, term)
        ap = nucleo_params(-10.0, -1.0, -0.5, -0.5).hole_params(*term)
        dlo, dhi = oracle.band_diag_range(len(a), len(b), radius)
        assert (dlo, dhi) == dp.band_range(len(a), len(b), radius)
        want, path = oracle.banded_nw(a, np.frombuffer(
            bytes(b).upper(), np.uint8), dlo, dhi, ap)
        got, paths = dp.align([(a, b)], [pen], radius, traceback=True)
        assert float(got[0]) == want
        assert paths[0].decode() == path
        assert dp.path_score(a, b, path.encode(), pen) == want


def test_dp_batches_equal_single_pairs():
    rng = np.random.default_rng(5)
    pairs, pens = [], []
    for _ in range(12):
        a = ACGT[rng.integers(0, 4, int(rng.integers(50, 300)))]
        pairs.append((a, _mutate(rng, a, 0.3)))
        pens.append(dp.penalties(1., -2., -10., -1., -.5, -.5, tuple(
            bool(x) for x in rng.integers(0, 2, 4))))
    s, p = dp.align(pairs, pens, 16, traceback=True)
    for k in range(len(pairs)):
        s1, p1 = dp.align([pairs[k]], [pens[k]], 16, traceback=True)
        assert s1[0] == s[k] and p1[0] == p[k]


def test_row_fields_equal_the_port_blast6():
    from usearch12_tpu_torch.align.result import AlignResult
    from usearch12_tpu_torch.out.blast6 import blast6_line
    rng = np.random.default_rng(8)
    a = ACGT[rng.integers(0, 4, 200)]
    b = _mutate(rng, a, 0.1)
    _, paths = dp.align([(a, b)], [dp.penalties(1, -2, -10, -1, -.5, -.5)],
                        32, traceback=True)
    ar = AlignResult(query_label="q", target_label="t", query_seq=a,
                     target_seq=b, path=paths[0].decode(), nucleo=True)
    assert dp.blast6_row("q", "t", a, b, paths[0]) + "\n" == blast6_line(ar)


def test_mask_equals_the_port_fast_mask():
    from usearch12_tpu_torch.cli import parse_argv
    from usearch12_tpu_torch.mask import fast_mask
    parse_argv(["-quiet"])
    rng = np.random.default_rng(3)
    for seqs in (ACGT[rng.integers(0, 2, (400, 60))],
                 ACGT[rng.integers(0, 4, (400, 253))]):
        want = np.stack([fast_mask(r, True) for r in seqs]) >= ord("a")
        assert np.array_equal(rank.fast_mask(seqs), want)


@pytest.mark.parametrize("tie", ["first_touch", "index"])
def test_ranking_against_the_port_ranker(tie):
    from usearch12_tpu_torch.cli import parse_argv
    from usearch12_tpu_torch.io.seqdb import SeqDB
    from usearch12_tpu_torch.index.udb import UDBIndex
    from usearch12_tpu_torch.ops.csr_rank import CSRDeviceRanker
    ref = otus.reference({"targets": 3000, "clusters": 1500, "length": 253,
                          "clades": 30, "cluster_subs": [3, 10],
                          "member_subs": [0, 3]}, gen.rng_for(4, 1))
    q, _ = subs.queries({"subs": [0, 5]}, ref, 100, gen.rng_for(4, 2))
    parse_argv(["-id", "0.97", "-strand", "plus", "-big", "1000", "-quiet"])
    db = SeqDB()
    for lab, s in zip(ref["labels"], ref["seqs"]):
        db.add(lab, s.copy())
    db.mask()
    ranker = CSRDeviceRanker(UDBIndex.from_seqdb(db), "cpu", topk=64)
    assert ranker.big
    cand, cnts, out_n, _ = ranker.rank_window(
        np.ascontiguousarray(q.reshape(-1)),
        np.arange(len(q) + 1, dtype=np.int64) * q.shape[1])
    lists = rank.rank(list(q), rank.target_words(ref["seqs"], 8, "cpu"),
                      0.97, 8, 8, 64, tie=tie)
    same = [np.array_equal(cand[j, :out_n[j]], lists[j][0])
            and np.array_equal(cnts[j, :out_n[j]], lists[j][1])
            for j in range(len(q))]
    # first touch is USEARCH's order; by index it differs where ties are,
    # which duplicates and near siblings make common
    if tie == "first_touch":
        assert all(same)
    else:
        assert sum(not s for s in same) > 10
