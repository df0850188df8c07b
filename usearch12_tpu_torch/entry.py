"""The port's entry points: one search step on a device
(entry) and a dry run of every mesh path (dryrun_multichip).

Port of __graft_entry__.py.

    python -m usearch12_tpu_torch.entry [N] [--device cpu]

runs entry()'s step, then dryrun_multichip(N) (N defaults to 8), on the
card unless --device cpu is given.  On the CPU the mesh has any shape,
every entry the CPU; on the card its entries go round-robin over the
cards present (on a host of one card, every entry is that card).
"""

from __future__ import annotations

import sys
import tempfile
from typing import List

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .parallel.mesh import Mesh
from .parallel.search_step import (build_incidence, letter_rows,
                                   make_search_step,
                                   make_sharded_search_step, query_onehot)

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AMAX = 256
# the entry's gap penalties: AlnParams.init4(-10, -1, -0.5, -0.5) in the
# JAX step's order (open a/b, ext a/b, left open a/b, right open a/b,
# left ext a/b, right ext a/b)
GAP_PENALTIES = [-10.0, -10.0, -1.0, -1.0, -0.5, -0.5, -0.5, -0.5,
                 -0.5, -0.5, -0.5, -0.5]


def _example_data(n_queries: int = 8, n_targets: int = 16, length: int = 200,
                  word_length: int = 5, seed: int = 3,
                  device: DeviceLike = None):
    """A small synthetic search problem (a short word length keeps the
    incidence small): the JAX entry's data from the same seed, as the
    step's tensors on `device`: (q_onehot, db_mat, a_cls, db_cls, db_len,
    gp)."""
    from .index.udb import UDBIndex, UDBParams
    from .io.seqdb import SeqDB
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    db = SeqDB()
    targets = []
    for t in range(n_targets):
        s = ACGT[rng.integers(0, 4, length)]
        targets.append(s)
        db.add(f"t{t}", s)
    db.set_is_nucleo(True)
    index = UDBIndex.from_seqdb(db, UDBParams.global_usearch(
        True, word_length=word_length))
    queries = []
    for q in range(n_queries):
        s = targets[q % n_targets].copy()
        idx = rng.integers(0, length, 8)
        s[idx] = ACGT[rng.integers(0, 4, 8)]
        queries.append(s)
    db_len = torch.tensor([len(s) for s in targets], dtype=torch.int32)
    return (query_onehot(index, queries, dev), build_incidence(index, dev),
            torch.from_numpy(letter_rows(queries, AMAX)).to(dev),
            torch.from_numpy(letter_rows(targets, AMAX)).to(dev),
            db_len.to(dev),
            torch.tensor(GAP_PENALTIES, dtype=torch.float32, device=dev))


def entry(device: DeviceLike = None):
    """The flagship pipeline's forward step (word counts by an int8
    product, the top candidate, its banded NW score) and its arguments on
    the device: (step, args)."""
    dev = resolve_device(device)
    return make_search_step(AMAX, dev), _example_data(device=dev)


def mesh_devices(n: int, device: DeviceLike = None) -> List[torch.device]:
    """n mesh entries: all the CPU when `device` is the CPU, else the cards
    present in turn."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", k % n_cards) for k in range(n)]


def mesh_shape(n_devices: int):
    """(n_data, n_db) of the JAX dry run's factoring: both axes used when
    possible (8 devices: 2 x 4)."""
    n_db = 1
    for cand in (2, 4, 8):
        if n_devices % cand == 0:
            n_db = cand
    if n_devices // n_db == 1 and n_db >= 4:
        n_db //= 2
    return n_devices // n_db, n_db


def _write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for label, s in records:
            f.write(f">{label}\n{s.tobytes().decode()}\n")


def _mutants(rng, tpls, n: int, n_sub: int):
    out = []
    for k in range(n):
        t = tpls[k % len(tpls)].copy()
        t[rng.integers(0, len(t), n_sub)] = ACGT[rng.integers(0, 4, n_sub)]
        out.append(t)
    return out


def _leg_step(mesh: Mesh, dev: torch.device):
    """The sharded step against the single-device step on the entry's
    data; returns its outputs and the shapes."""
    n_data, n_db = mesh.shape["data"], mesh.shape["db"]
    args = _example_data(n_queries=2 * n_data * 4, n_targets=4 * n_db,
                         device=dev)
    counts, tops, scores = make_sharded_search_step(mesh, AMAX)(*args)
    ref = make_search_step(AMAX, dev)(*args)
    for name, x, y in zip(("counts", "tops", "scores"),
                          (counts, tops, scores), ref):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"sharded step's {name} differ from the "
                                 "single-device step's")
    n_t = args[3].shape[0]
    if not (bool((tops >= 0).all()) and bool((tops < n_t).all())
            and bool(torch.isfinite(scores).all())):
        raise AssertionError("sharded step: a top outside the targets or a "
                             "score not finite")
    return counts.cpu().numpy(), args[0].shape[0], n_t


def _leg_cluster(mesh: Mesh, td: str) -> None:
    """cluster_mt over the mesh (the U counter) against the host
    cluster_mt: equal -uc."""
    from .cli import parse_argv
    from .cluster.uclust import cluster_mt
    from .parallel.cluster_batch import cluster_mt_batched
    rng = np.random.default_rng(5)
    tpls = [ACGT[rng.integers(0, 4, 150)] for _ in range(5)]
    in_fa = f"{td}/in.fa"
    _write_fasta(in_fa, [(f"r{k}", s) for k, s in
                         enumerate(_mutants(rng, tpls, 40, 3))])
    h_uc, d_uc = f"{td}/h.uc", f"{td}/d.uc"
    for uc in (h_uc, d_uc):
        parse_argv(["-cluster_mt", in_fa, "-id", "0.95", "-maxpending", "8",
                    "-uc", uc, "-quiet", "-use_cpu_oracle"])
        if uc == h_uc:
            cluster_mt(in_fa)
    cluster_mt_batched(in_fa, mesh=mesh)
    with open(h_uc) as f, open(d_uc) as g:
        if f.read() != g.read():
            raise AssertionError("cluster_mt over the mesh diverged from "
                                 "the host path")


def _leg_search(mesh: Mesh, td: str) -> None:
    """usearch_global ranked over the mesh against the host BatchEngine:
    equal blast6."""
    from .cli import parse_argv
    from .engine.batch import BatchEngine
    from .engine.emit import Blast6Emitter
    from .io.seqdb import SeqDB
    from .parallel.mesh_search import mesh_search_file
    rng = np.random.default_rng(9)
    tpls = [ACGT[rng.integers(0, 4, 160)] for _ in range(12)]
    db_fa, q_fa = f"{td}/db.fa", f"{td}/q.fa"
    _write_fasta(db_fa, [(f"t{k}", t) for k, t in enumerate(tpls)])
    _write_fasta(q_fa, [(f"q{k}", s) for k, s in
                        enumerate(_mutants(rng, tpls, 36, 5))])
    parse_argv(["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
                "-strand", "plus", "-quiet"])
    sdb = SeqDB.from_fastx(db_fa)
    sdb.mask()
    with open(f"{td}/mesh.b6", "w") as f:
        st = mesh_search_file(q_fa, sdb, mesh, lambda *a: None,
                              fast_emit=Blast6Emitter(f, sdb, False).emit,
                              window=16, topk=16)
    with open(f"{td}/host.b6", "w") as f:
        BatchEngine("usearch_global", sdb).run_file(
            q_fa, lambda *a: None,
            fast_emit=Blast6Emitter(f, sdb, False).emit)
    with open(f"{td}/mesh.b6") as f, open(f"{td}/host.b6") as g:
        if f.read() != g.read():
            raise AssertionError("usearch_global over the mesh diverged "
                                 "from the host blast6")
    if st["fallbacks"] != 0:
        raise AssertionError(f"{st['fallbacks']} jobs ranked on the host")


def _leg_cli(spec: str, dev: torch.device, td: str) -> None:
    """The command line with -mesh spec against the host command line:
    equal -blast6out and -uc."""
    from .cli import main
    rng = np.random.default_rng(23)
    tpls = [ACGT[rng.integers(0, 4, 150)] for _ in range(10)]
    db_fa, q_fa = f"{td}/db.fa", f"{td}/q.fa"
    _write_fasta(db_fa, [(f"t{k}", t) for k, t in enumerate(tpls)])
    _write_fasta(q_fa, [(f"q{k}", s) for k, s in
                        enumerate(_mutants(rng, tpls, 30, 4))])
    search = ["-usearch_global", q_fa, "-db", db_fa, "-id", "0.9",
              "-strand", "plus", "-quiet"]
    cluster = ["-cluster_mt", q_fa, "-id", "0.95", "-maxpending", "8",
               "-quiet"]
    mesh = ["-mesh", spec]
    if main(search + ["-blast6out", f"{td}/m.b6"] + mesh, device=dev) != 0 \
            or main(search + ["-blast6out", f"{td}/h.b6"]) != 0:
        raise AssertionError("usearch_global exited non-zero")
    with open(f"{td}/m.b6") as f, open(f"{td}/h.b6") as g:
        m_b6 = f.read()
        if m_b6 != g.read() or not m_b6:
            raise AssertionError("-mesh usearch_global diverged from the "
                                 "host command line's blast6 (or no hits)")
    if main(cluster + ["-uc", f"{td}/m.uc"] + mesh, device=dev) != 0 \
            or main(cluster + ["-uc", f"{td}/h.uc"]) != 0:
        raise AssertionError("cluster_mt exited non-zero")
    with open(f"{td}/m.uc") as f, open(f"{td}/h.uc") as g:
        if f.read() != g.read():
            raise AssertionError("-mesh cluster_mt diverged from the host "
                                 "command line's -uc")


def _leg_align(devices: List[torch.device], n_devices: int) -> None:
    """The hole DP split over a flat "data" mesh of every entry against
    one device: bit-equal scores and paths."""
    from .ops.wavefront_nw import TorchWaveAligner, nucleo_params
    ap = nucleo_params(-10.0, -1.0, -0.5, -0.5)
    rng = np.random.default_rng(1)
    pairs = []
    for _ in range(3 * n_devices):
        n = int(rng.integers(40, 120))
        a = rng.integers(0, 4, n)
        b = a.copy()
        b[rng.integers(0, n, 4)] = rng.integers(0, 4, 4)
        pairs.append((ACGT[a], ACGT[b]))
    aligner = TorchWaveAligner(ap, devices[0])
    s1, p1 = aligner.align(pairs, 16)
    s2, p2 = aligner.align_sharded(pairs, 16, Mesh([[d] for d in devices]))
    if s1.view(np.int32).tolist() != s2.view(np.int32).tolist() or p1 != p2:
        raise AssertionError("sharded hole DP diverged from one device")


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """Every mesh path on an (n_data x n_db) mesh of n_devices entries:
    the sharded search step (against the single-device step), cluster_mt
    over the mesh (-uc equal to the host path), usearch_global ranked over
    the mesh (blast6 equal to the host engine), the command line with
    -mesh (blast6 and -uc equal to the host command line) and the hole DP
    split over the entries (bit-equal to one device).  Raises on any
    difference."""
    dev = resolve_device(device)
    n_data, n_db = mesh_shape(n_devices)
    devices = mesh_devices(n_devices, dev)
    mesh = Mesh([devices[i * n_db:(i + 1) * n_db] for i in range(n_data)])
    print(f"dryrun_multichip: {mesh}", flush=True)
    counts, n_q, n_t = _leg_step(mesh, dev)
    # the command line builds its own mesh, which takes one card an entry
    spec = f"{n_data}x{n_db}"
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        spec = str(torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as td:
        _leg_cluster(mesh, td)
        _leg_search(mesh, td)
        _leg_cli(spec, dev, td)
    _leg_align(devices, n_devices)
    print(f"dryrun_multichip OK: mesh {dict(data=n_data, db=n_db)}, "
          f"{n_q} queries x {n_t} targets, top counts "
          f"{counts[:4].tolist()}; cluster_mt, usearch_global and the "
          f"command line (-mesh {spec}) equal to the host paths; the "
          f"sharded hole DP bit-equal to one device", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = None
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        del argv[k:k + 2]
    n = int(argv[0]) if argv else 8
    step, args = entry(device)
    out = step(*args)
    print("entry OK:", [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(n, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
