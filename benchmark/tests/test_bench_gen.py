"""The generators: the same seed gives the same data, and the data has the
stated sizes, levels and identities."""

import json
import os

import numpy as np

from benchmark import gen
from benchmark.generators import otus, subs

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")
SPEC = {"generator": "otus", "targets": 1200, "clusters": 600,
        "length": 253, "clades": 12, "cluster_subs": [3, 10],
        "member_subs": [0, 3]}


def test_same_seed_same_data_and_other_seed_other_data():
    a = otus.reference(SPEC, gen.rng_for(2 ** 31 + 5, 1))
    b = otus.reference(SPEC, gen.rng_for(2 ** 31 + 5, 1))
    c = otus.reference(SPEC, gen.rng_for(2 ** 31 + 6, 1))
    assert np.array_equal(a["seqs"], b["seqs"])
    assert not np.array_equal(a["seqs"], c["seqs"])
    assert a["seqs"].shape == (1200, 253)
    assert set(np.unique(a["seqs"]).tolist()) <= set(b"ACGT")


def test_substitutions_are_distinct_and_change_the_base():
    rng = gen.rng_for(7)
    seqs = gen.ACGT[rng.integers(0, 4, (300, 253))]
    orig = seqs.copy()
    k = rng.integers(0, 9, 300)
    gen.substitute(rng, seqs, k)
    assert np.array_equal((seqs != orig).sum(1), k)


def test_otus_have_duplicates_near_siblings_and_clades():
    seqs = otus.reference(SPEC, gen.rng_for(9, 1))["seqs"]
    d = (seqs[:, None, :] != seqs[None, :, :]).sum(2)
    np.fill_diagonal(d, 10 ** 6)
    nearest = d.min(1)
    # a member's centroid is at most 3 away, and half the targets are
    # members; about a quarter of those duplicate their centroid
    assert (nearest <= 3).mean() > 0.5
    assert (nearest == 0).mean() > 0.1
    # targets of one clade are at most 2 x (10 + 3) apart, of two clades
    # about three quarters of the letters
    assert np.median(nearest) <= 3
    assert ((d > 26) & (d < 120)).sum() == 0


def test_read_mixes_have_their_substitution_counts():
    ref = otus.reference(SPEC, gen.rng_for(1, 1))
    for lo_hi in ([0, 5], [20, 30]):
        q, parents = subs.queries({"subs": lo_hi}, ref, 400,
                                  gen.rng_for(1, 2))
        d = (q != ref["seqs"][parents]).sum(1)
        assert d.min() == lo_hi[0] and d.max() == lo_hi[1]


def test_make_data_finds_generators_by_name_and_cuts_requests():
    cfg = {"reference": dict(SPEC)}
    tr = {"per_request": 50, "pool": 3, "label": "r",
          "query": {"generator": "subs", "subs": [0, 5]}}
    bench = os.path.dirname(CONFIGS)
    ref, reqs = gen.make_data(bench, cfg, tr, 5)
    ref2, reqs2 = gen.make_data(bench, cfg, tr, 5)
    assert len(reqs) == 3 and reqs[2]["labels"][0] == "r2_0"
    assert all(np.array_equal(a["seqs"], b["seqs"])
               for a, b in zip(reqs, reqs2))
    assert reqs[1]["seqs"].shape == (50, 253)


def test_gg99_reference_has_the_configured_size():
    with open(os.path.join(CONFIGS, "gg99_v4.json")) as f:
        spec = json.load(f)["reference"]
    assert (spec["targets"], spec["clusters"], spec["length"]) == \
        (203452, 99322, 253)
