"""Where a split chain round starts to pay: chain rounds of V4-length reads
serially (one chain_batch_c call) and cut into S slices chained at once
(BatchEngine._chain_split), and print, a line a round size, both times
and the letters a slice takes.  The reads are the cheapest to chain a
letter that the benchmark sends (253 nt at 88-92% to their nearest
target, no hole of 2,048 cells), so the smallest slice that pays here
pays for every read length; engine/batch.py's SLICE_MIN_LETTERS is that
size, rounded up.

    python tools/chain_split_floor.py [--reps 30] [--pause 12] [--out FILE]

Each time is the median of --reps calls after one warm call, on the
host clock, each call --pause ms after the last one ended: a request's
first round comes after its rank (about 12 ms for 512 reads), by when
the threads of the split before it have gone to sleep.  The last line is
the smallest letters a slice at which every S measured was faster split,
of the round sizes measured.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, seq, n_subs):
    out = seq.copy()
    pos = rng.choice(len(seq), n_subs, replace=False)
    out[pos] = ACGT[(np.searchsorted(ACGT, seq[pos])
                     + rng.integers(1, 4, n_subs)) % 4]
    return out


def _fasta(path, seqs, tag):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{tag}{i}\n{s.tobytes().decode()}\n")


def make_set(d, rng, n_clades=200, members=20, n_reads=512):
    """4,000 targets of 253 nt in clades of 20 (0-8 substitutions from
    their template), and reads 20-30 substitutions from a target."""
    targets = []
    for _ in range(n_clades):
        t = ACGT[rng.integers(0, 4, 253)]
        targets += [_mutate(rng, t, int(rng.integers(0, 9)))
                    for _ in range(members)]
    reads = [_mutate(rng, targets[int(rng.integers(0, len(targets)))],
                     int(rng.integers(20, 31))) for _ in range(n_reads)]
    db, q = os.path.join(d, "db.fa"), os.path.join(d, "q.fa")
    _fasta(db, targets, "t")
    _fasta(q, reads, "r")
    return db, q


def median_time(fn, reps, pause):
    fn()
    ts = []
    for _ in range(reps):
        time.sleep(pause)
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--pause", type=float, default=12.0,
                   help="ms between calls")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from usearch12_tpu_torch.cli import parse_argv
    from usearch12_tpu_torch.engine import batch
    from usearch12_tpu_torch.io.seqdb import SeqDB
    cores = len(os.sched_getaffinity(0))
    lines = []
    with tempfile.TemporaryDirectory() as d:
        db, q = make_set(d, np.random.default_rng(22))
        parse_argv(["-usearch_global", q, "-db", db, "-id", "0.97",
                    "-strand", "plus", "-quiet"])
        sdb = SeqDB.from_fastx(db)
        sdb.mask()
        eng = batch.BatchEngine("usearch_global", sdb)
        win = batch._FastaWindows(q)
        jbuf = np.ascontiguousarray(win.seq_buf[:win.seq_off[win.n]])
        j_off = win.seq_off[:win.n + 1].astype(np.int64)
        cand, _, out_n = eng._rank_jobs(jbuf, j_off)
    n_s = sorted({s for s in (2, 4, 8, batch._thread_count()) if s <= cores})
    pays = {}
    for depth in (1, 8):
        for n_jobs in (2, 4, 8, 16, 32, 64, 128, 256, 512):
            take = np.minimum(out_n[:n_jobs], depth)
            pair_j = np.repeat(np.arange(n_jobs), take).astype(np.int32)
            within = np.concatenate([np.arange(t) for t in take])
            pair_t = np.ascontiguousarray(cand[pair_j, within])
            letters = int((j_off[pair_j + 1] - j_off[pair_j]).sum()
                          + eng._db_len[pair_t].sum())
            sc = eng._sc
            t1 = median_time(lambda: eng._chain_call(sc, jbuf, j_off, pair_j,
                                                     pair_t), args.reps,
                             args.pause / 1e3)
            row = {"depth": depth, "jobs": n_jobs, "pairs": len(pair_j),
                   "letters": letters, "serial_us": round(t1 * 1e6, 1)}
            for s in n_s:
                if s > n_jobs:
                    continue
                cuts = eng._slice_cuts(j_off, pair_j, pair_t, s)
                ts = median_time(lambda: eng._chain_split(
                    sc, jbuf, j_off, pair_j, pair_t, cuts), args.reps,
                    args.pause / 1e3)
                row[f"split{s}_us"] = round(ts * 1e6, 1)
                pays.setdefault(letters // s, []).append(ts < t1)
            print(json.dumps(row), flush=True)
            lines.append(row)
    # the smallest letters a slice from which every measured split paid
    sizes = sorted(pays)
    floor = next((x for i, x in enumerate(sizes)
                  if all(all(pays[y]) for y in sizes[i:])), None)
    end = {"cores": cores, "threads": batch._thread_count(),
           "pause_ms": args.pause,
           "floor_letters_a_slice": floor}
    print(json.dumps(end), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": lines, **end}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
