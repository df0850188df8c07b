#!/usr/bin/env python3
"""Where wavefront_trace's two kernels cross, on one CUDA card.

    python3 trace_crossover.py          # from the root of a checkout

The wrapper (usearch12_tpu_torch/ops/wavefront_trace.py) takes the warp
kernel while a launch's load, its pairs' la + lb steps summed and divided
by its longest pair's, stays below WARP_MAX_LOAD, and the thread kernel
above.  This script measures both kernels alone (their entry point called
directly, inputs made beforehand, in turns warp, thread, thread, warp,
bit-equal to each other) on:

  1. uniform launches: pairs of 250, 600 and 1,000 nt (band radius 16,
     60 and 120) at 4,096 to 32,768 pairs, and the crossing load of each
     length, interpolated between the two sizes where the faster kernel
     changes;
  2. amplicon reads through the port's command line, 8,192 reads against
     1,024 targets with `-strand plus -dev_batch_cells 1`, whose hole DP
     launches are recorded and replayed: long reads of 4,500 nt (rRNA
     operons) at about 75% identity (`-id 0.7`), and reads of 1,500 nt
     (full-length 16S) at about 84% identity (`-id 0.75`).

Each line gives a launch's pairs, load, both kernels' times and the
wrapper's choice, with the card's name and power limit first.
"""

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def both_kernels(tag, targs):
    """Both kernels on the wrapper's arguments targs, bit-equal, timed in
    turns; returns the line's numbers."""
    import torch
    from chip_smoke import bit_equal, cuda_ms, fail, raw_trace
    from usearch12_tpu_torch import _build
    from usearch12_tpu_torch.ops import wavefront_trace as wtr
    lib = _build.load_library()
    la, lb, bw = targs[4], targs[5], targs[7]
    steps = (la + lb).to(torch.int64)
    total, longest = int(steps.sum()), int(steps.max())
    stride = wtr.ops_stride(longest)
    order = torch.argsort(la + lb, descending=True, stable=True).to(
        torch.int32)
    nb_max = ((int(bw.max()) + 1) // 2 + 1) // 2
    plans = {name: (order, nb_max, warp)
             for name, warp in (("warp", True), ("thread", False))}
    outs = {name: raw_trace(lib, True, targs, stride, p)
            for name, p in plans.items()}
    if not all(bit_equal(x, y) for x, y in zip(outs["warp"],
                                               outs["thread"])):
        fail(f"{tag}: the warp and thread kernels differ")
    times = {name: [] for name in plans}
    for name in ("warp", "thread", "thread", "warp"):
        times[name].append(cuda_ms(
            lambda: raw_trace(lib, True, targs, stride, plans[name]), 3)[0])
    best = {k: min(v) for k, v in times.items()}
    pick = "warp" if wtr.takes_warp_kernel(total, longest) else "thread"
    row = {"tag": tag, "pairs": int(la.numel()), "steps": total,
           "longest": longest, "load": round(total / longest, 1),
           "widest_band": int(bw.max()), "warp_ms": times["warp"],
           "thread_ms": times["thread"], "faster": min(best, key=best.get),
           "wrapper_takes": pick}
    print(json.dumps(row), flush=True)
    return row


def uniform(rng, n, length, radius, ap, dev):
    """Targs of n pairs of `length` (chip_smoke's kernel_pairs) after the
    forward kernel."""
    from chip_smoke import kernel_pairs
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    pairs = kernel_pairs(rng, n, length)
    w = wnw.pack_launch(pairs, *wnw.pair_geometry(pairs, radius), dev)
    gp = wnw.gap_params(ap).to(dev)
    tb, mlast, dlb = wnw.wavefront_fwd(*w, gp, *wnw.match_mismatch(ap))
    return (tb, w.tb_off, mlast, dlb, w.la, w.lb, w.dlo, w.bw, gp)


def crossing(rows):
    """The load at which the faster kernel changes from warp to thread,
    interpolated on the ratio of their times; None if it does not."""
    import math
    pts = [(r["load"], math.log(min(r["thread_ms"]) / min(r["warp_ms"])))
           for r in rows]
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        if y0 >= 0 > y1:
            return round(x0 + y0 * (x1 - x0) / (y0 - y1))
    return None


def amplicon_reads(d, length, sub, indels, n_q=8192, n_t=1024, seed=3):
    """n_q reads of `length` nt, each one of n_t random targets with a
    fraction `sub` of substitutions and `indels` single-letter indels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    targets = [rng.integers(0, 4, length) for _ in range(n_t)]
    tf, qf = (os.path.join(d, f"{x}{length}.fa") for x in "tq")
    with open(tf, "w") as f:
        for i, t in enumerate(targets):
            f.write(f">t{i}\n{conv[t].tobytes().decode()}\n")
    with open(qf, "w") as f:
        for i in range(n_q):
            s = targets[i % n_t].copy()
            flip = rng.random(length) < sub
            s[flip] = rng.integers(0, 4, int(flip.sum()))
            for _ in range(indels):
                p = int(rng.integers(0, len(s)))
                s = (np.delete(s, p) if rng.random() < 0.5
                     else np.insert(s, p, rng.integers(0, 4)))
            f.write(f">q{i}\n{conv[s].tobytes().decode()}\n")
    return qf, tf


def main():
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    from chip_smoke import fail
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from usearch12_tpu_torch import cli
    from usearch12_tpu_torch.device import card_info
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    from usearch12_tpu_torch.ops import wavefront_trace as wtr
    dev = torch.device("cuda:0")
    print(card_info(0), flush=True)
    print(f"WARP_MAX_LOAD {wtr.WARP_MAX_LOAD}", flush=True)
    ap = wnw.nucleo_params(-10.0, -1.0, -0.5, -0.5)
    rng = np.random.default_rng(5)
    cross = {}
    for length, radius in ((250, 16), (600, 60), (1000, 120)):
        rows = []
        for n in (4096, 8192, 12288, 16384, 24576, 32768):
            targs = uniform(rng, n, length, radius, ap, dev)
            rows.append(both_kernels(f"{n} x {length} nt", targs))
            del targs
            torch.cuda.empty_cache()
        cross[length] = crossing(rows)
    print(f"crossing loads by length: {json.dumps(cross)}", flush=True)

    gp = wnw.gap_params(ap).to(dev)
    for name, length, sub, indels, ident in (
            ("operon reads", 4500, 0.2, 20, "0.7"),
            ("16S reads", 1500, 0.15, 6, "0.75")):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            qf, tf = amplicon_reads(d, length, sub, indels)
            pack, seen = wnw.pack_launch, []

            def capture(*a, **k):
                w = pack(*a, **k)
                seen.append(w)
                return w
            wnw.pack_launch = capture
            try:
                t1 = time.perf_counter()
                rc = cli.main(["-usearch_global", qf, "-db", tf, "-id",
                               ident, "-strand", "plus", "-quiet",
                               "-dev_batch_cells", "1", "-blast6out",
                               os.path.join(d, "o.b6")])
                t_run = time.perf_counter() - t1
            finally:
                wnw.pack_launch = pack
            if rc != 0:
                fail(f"usearch12_tpu_torch.cli exited {rc}")
            print(f"{name}: 8,192 x {length} nt against 1,024 targets, "
                  f"-id {ident}, made in {t1 - t0:.1f} s, searched in "
                  f"{t_run:.1f} s; {len(seen)} launches of "
                  f"{[int(w.la.numel()) for w in seen]} pairs", flush=True)
            for k, w in enumerate(seen):
                tb, mlast, dlb = wnw.wavefront_fwd(*w, gp,
                                                   *wnw.match_mismatch(ap))
                both_kernels(f"{name} launch {k}", (tb, w.tb_off, mlast, dlb,
                                                    w.la, w.lb, w.dlo, w.bw,
                                                    gp))
                del tb, mlast, dlb
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
