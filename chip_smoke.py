#!/usr/bin/env python3
"""Smoke run of usearch12_tpu_torch on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing a line, any failure exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA kernels of usearch12_tpu_torch/csrc with nvcc;
  3. kernels: the hole DP kernels (wavefront_fwd, wavefront_trace)
     against their plain PyTorch versions on the card,
     bit for bit, at 65,536 pairs of 250 nt (band radius 16) and 512
     pairs of 3 kb (band radius 120, non-dyadic gap penalties), and a
     256-pair subsample against the host C kernel nw_band;
  4. oracle: the row-sweep kernels of the device oracle BandedNWDevice
     (banded_nw_fwd, banded_nw_chase) bit for bit against their plain
     versions at the 65,536 pairs of 250 nt (radius 16) and at 2,048
     pairs of 1 kb (radius 62, band 125, non-dyadic gap penalties); then
     BandedNWDevice.align_device on all 65,536 pairs of 250 nt, whose
     scores and paths must equal those of TorchWaveAligner.align (the
     hole DP kernels of phase 3) on every pair;
  5. slice: usearch_global through the port's command line
     (usearch12_tpu_torch.cli.main, in this process so that the kernels'
     launch counts can be read) on the long-contig workload (32 queries x
     32 targets of 24,150 nt), whose blast6 bytes must equal those of
     `python -m usearch12_tpu.cli ... -no_engine_device`, the JAX
     package's host C path, with the device and host cells and both
     kernels' launch counts of that run;
  6. sintax kernels: sintax_pick_hist and sintax_boot_select bit for bit
     against their plain versions on one full chunk of the SINTAX workload
     (128 jobs x 100 boots x 256 word slots against the 60,000-target
     incidence), at m = 32, at m = 200 (> 127) and at m = 0 (every target
     ties), with the gather and the product timed beside them;
  7. sintax: the JAX package's SINTAX device workload (bench.py's
     _gen_sintax_big, seed 17, not cut: 60,000 targets of 248 nt, 1,500
     queries, -strand both -randseed 1) through the port's command line
     with -sintax_device, in this process, whose -tabbedout bytes must
     equal those of `python -m usearch12_tpu.cli ... -no_sintax_device`,
     the JAX package's host path; then the auto gate's measurement (the
     port's command line as a fresh process, host and card twice each, at
     5,000, 20,000, 60,000 and 90,000 targets, with the start-up costs
     of such a process) and one profiled card run.
Each phase prints its seconds.  The line before the last is the kernel
summary as JSON, the last line {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
COMMON = ["-id", "0.5", "-strand", "plus", "-band", "120",
          "-maxaccepts", "64", "-maxrejects", "64", "-quiet"]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gen_longseq(qf, tf, n=32, seed=21):
    """The long-sequence device workload (recipe of bench.py's
    _gen_longseq): 24,150-nt contigs of 13 conserved 150-nt blocks and 12
    divergent 1,850-nt segments; queries re-roll 50% of each segment."""
    import numpy as np
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    n_block, blk, n_var, var = 13, 150, 12, 1850
    blocks = [conv[rng.integers(0, 4, blk)] for _ in range(n_block)]

    def assemble(segs):
        parts = []
        for k in range(n_var):
            parts += [blocks[k], segs[k]]
        parts.append(blocks[n_var])
        return np.concatenate(parts)

    targets = []
    with open(tf, "w") as f:
        for i in range(n):
            segs = [conv[rng.integers(0, 4, var)] for _ in range(n_var)]
            targets.append(segs)
            f.write(f">lt{i}\n{assemble(segs).tobytes().decode()}\n")
    with open(qf, "w") as f:
        for i in range(n):
            segs = []
            for s in targets[i % len(targets)]:
                t = s.copy()
                flip = rng.random(var) < 0.5
                t[flip] = conv[rng.integers(0, 4, int(flip.sum()))]
                segs.append(t)
            f.write(f">lq{i}\n{assemble(segs).tobytes().decode()}\n")


def gen_sintax(dbf, qf, n_targets=60000, n_queries=1500, seed=17):
    """The SINTAX device workload (recipe of bench.py's _gen_sintax_big):
    248-nt targets with taxonomy d:D{i%5},p:P{i%40},g:G{i%400}; each query
    is target (13 i) % n_targets with 8 substitutions."""
    import numpy as np
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    seqs = []
    with open(dbf, "w") as f:
        for i in range(n_targets):
            s = conv[rng.integers(0, 4, 248)]
            seqs.append(s)
            f.write(f">r{i};tax=d:D{i % 5},p:P{i % 40},g:G{i % 400};\n"
                    f"{s.tobytes().decode()}\n")
    with open(qf, "w") as f:
        for i in range(n_queries):
            s = seqs[(i * 13) % len(seqs)].copy()
            pos = rng.integers(0, len(s), 8)
            s[pos] = conv[rng.integers(0, 4, 8)]
            f.write(f">q{i}\n{s.tobytes().decode()}\n")


def kernel_pairs(rng, n, length, sub_rate=0.1, indel=8):
    """n (a, b) pairs: b is a with ~sub_rate substitutions and a few
    indels, so lengths differ by up to `indel`."""
    import numpy as np
    conv = np.frombuffer(b"ACGT", np.uint8)
    a = rng.integers(0, 4, (n, length))
    b = a.copy()
    flip = rng.random((n, length)) < sub_rate
    b[flip] = rng.integers(0, 4, int(flip.sum()))
    pairs = []
    for k in range(n):
        d = int(rng.integers(-indel, indel + 1))
        bk = b[k]
        if d > 0:
            pos = np.sort(rng.integers(0, length, d))
            bk = np.insert(bk, pos, rng.integers(0, 4, d))
        elif d < 0:
            bk = np.delete(bk, rng.choice(length, -d, replace=False))
        pairs.append((conv[a[k]], conv[bk]))
    return pairs


def bit_equal(x, y):
    import torch
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return x.shape == y.shape and bool(torch.equal(x, y))


def balanced_indel_pairs(rng, n, length, max_indel=40, sub_rate=0.1):
    """n (a, b) pairs of equal length: b is a with ~sub_rate
    substitutions, k single-letter deletions and k single-letter
    insertions, 2k <= max_indel."""
    import numpy as np
    conv = np.frombuffer(b"ACGT", np.uint8)
    a = rng.integers(0, 4, (n, length))
    b = a.copy()
    flip = rng.random((n, length)) < sub_rate
    b[flip] = rng.integers(0, 4, int(flip.sum()))
    pairs = []
    for k in range(n):
        m = int(rng.integers(0, max_indel // 2 + 1))
        bk = np.delete(b[k], rng.choice(length, m, replace=False))
        bk = np.insert(bk, np.sort(rng.integers(0, length - m + 1, m)),
                       rng.integers(0, 4, m))
        pairs.append((conv[a[k]], conv[bk]))
    return pairs


def cuda_ms(fn, reps, warm=True):
    """Mean device time of fn() over reps runs, after one warm-up unless
    warm is False."""
    import torch
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def check_kernels(tag, pairs, radius, ap, dev, reps):
    """Kernels against plain versions on `pairs`; returns a dict of
    times and errors."""
    import numpy as np
    import torch
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    from usearch12_tpu_torch.ops import wavefront_trace as wtr
    geo = wnw.pair_geometry(pairs, radius)
    w = wnw.pack_launch(pairs, *geo, dev)
    gp = wnw.gap_params_from_jax(ap).to(dev)
    match, mismatch = wnw.match_mismatch(ap)
    fwd_ms, fwd = cuda_ms(lambda: wnw.wavefront_fwd(*w, gp, match, mismatch),
                          reps)
    fwd_plain_ms, fwd_plain = cuda_ms(
        lambda: wnw.wavefront_fwd_plain(*w, gp, match, mismatch), 1)
    for name, x, y in zip(("tb", "mlast", "dlb"), fwd, fwd_plain):
        if not bit_equal(x, y):
            fail(f"{tag}: wavefront_fwd {name} differs from its plain "
                 "version")
    tb, mlast, dlb = fwd
    targs = (tb, w.tb_off, mlast, dlb, w.la, w.lb, w.dlo, w.bw, gp)
    tr_ms, tr = cuda_ms(lambda: wtr.wavefront_trace(*targs), reps)
    stride = tr[1].shape[1]
    tr_plain_ms, tr_plain = cuda_ms(
        lambda: wtr.wavefront_trace_plain(*targs, stride), 1)
    for name, x, y in zip(("scores", "ops", "lens"), tr, tr_plain):
        if not bit_equal(x, y):
            fail(f"{tag}: wavefront_trace {name} differs from its plain "
                 "version")
    scores = tr[0].cpu().numpy()
    paths = wtr.decode_ops(tr[1].cpu().numpy(), tr[2].cpu().numpy())
    if not np.isfinite(scores).all():
        fail(f"{tag}: non-finite scores")
    sub = np.random.default_rng(0).choice(len(pairs), min(256, len(pairs)),
                                          replace=False)
    s_nat, p_nat = wnw.native_nw_band([pairs[k] for k in sub], radius, ap)
    if not (np.array_equal(s_nat, scores[sub])
            and p_nat == [paths[k] for k in sub]):
        fail(f"{tag}: kernels differ from the host C nw_band")
    cells = int((np.minimum(geo[0], geo[1]) * (2 * radius + 1)).sum())
    err = max(float((fwd[1] - fwd_plain[1]).abs().max()),
              float((fwd[2] - fwd_plain[2]).abs().max()))
    print(f"kernels {tag}: {len(pairs)} pairs, {cells} cells; "
          f"wavefront_fwd {fwd_ms:.3f} ms ({cells / fwd_ms / 1e6:.2f} "
          f"Gcells/s), plain {fwd_plain_ms:.1f} ms; wavefront_trace "
          f"{tr_ms:.3f} ms ({cells / tr_ms / 1e6:.2f} Gcells/s), plain "
          f"{tr_plain_ms:.1f} ms; "
          f"bit-equal to plain, {len(sub)} pairs equal to nw_band",
          flush=True)
    return {"fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
            "fwd_err": err, "trace_ms": tr_ms,
            "trace_plain_ms": tr_plain_ms,
            "trace_err": float((tr[0] - tr_plain[0]).abs().max())}


def check_banded(tag, pairs, radius, ap, dev, reps):
    """The device oracle's kernels against their plain versions on
    `pairs`; returns a dict of times and errors."""
    import numpy as np
    import torch
    from usearch12_tpu_torch.ops import banded_nw as bn
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    batch = bn.pack_pairs(pairs, True, radius)
    geo = tuple(torch.from_numpy(x).to(dev) for x in (
        batch.la, batch.lb, batch.dlo, batch.bw))
    a_let, b_let = (torch.from_numpy(x).to(dev)
                    for x in (batch.a_let, batch.b_let))
    gp = wnw.gap_params_from_jax(ap).to(dev)
    match, mismatch = wnw.match_mismatch(ap)
    fwd_ms, fwd = cuda_ms(lambda: bn.banded_nw_fwd(
        a_let, b_let, *geo, gp, match, mismatch), reps)
    width = fwd[1].shape[1]
    fwd_plain_ms, fwd_plain = cuda_ms(lambda: bn.banded_nw_fwd_plain(
        a_let, b_let, *geo, gp, match, mismatch, width), 1, warm=False)
    for name, x, y in zip(("tb", "mlast", "dlb"), fwd, fwd_plain):
        if not bit_equal(x, y):
            fail(f"oracle {tag}: banded_nw_fwd {name} differs from its "
                 "plain version")
    fwd_err = max(float((fwd[1] - fwd_plain[1]).abs().max()),
                  float((fwd[2] - fwd_plain[2]).abs().max()))
    del fwd_plain
    tb, mlast, dlb = fwd
    ch_ms, ch = cuda_ms(lambda: bn.banded_nw_chase(tb, mlast, dlb, *geo,
                                                   gp), reps)
    stride = ch[3].shape[1]
    ch_plain_ms, ch_plain = cuda_ms(lambda: bn.banded_nw_chase_plain(
        tb, mlast, dlb, *geo, gp, stride), 1, warm=False)
    for name, x, y in zip(("scores", "states", "tblast", "ops"), ch,
                          ch_plain):
        if not bit_equal(x, y):
            fail(f"oracle {tag}: banded_nw_chase {name} differs from its "
                 "plain version")
    if not torch.isfinite(ch[0]).all():
        fail(f"oracle {tag}: non-finite scores")
    cells = int((np.minimum(batch.la, batch.lb).astype(np.int64)
                 * (2 * radius + 1)).sum())
    print(f"oracle {tag}: {len(pairs)} pairs, {cells} cells; banded_nw_fwd "
          f"{fwd_ms:.3f} ms ({cells / fwd_ms / 1e6:.2f} Gcells/s), plain "
          f"{fwd_plain_ms:.1f} ms; banded_nw_chase {ch_ms:.3f} ms "
          f"({cells / ch_ms / 1e6:.2f} Gcells/s), plain {ch_plain_ms:.1f} "
          "ms; bit-equal to plain", flush=True)
    return {"fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
            "fwd_err": fwd_err,
            "chase_ms": ch_ms, "chase_plain_ms": ch_plain_ms,
            "chase_err": float((ch[0] - ch_plain[0]).abs().max())}


def lcg_stream(n, seed=1):
    """The first n draws of SINTAX's per-query boot LCG
    (src/sintaxsearcher.cpp:77-82), seeded at -randseed."""
    import numpy as np
    out, r = np.empty(n, np.uint32), seed
    for k in range(n):
        r = (1664525 * r + 1013904223) & 0xFFFFFFFF
        out[k] = r
    return out


def sintax_chunks(dbf, qf, d):
    """One full chunk of real jobs, as the port's classifier hands it to
    TorchBootEngine.run_chunk on the first 64 queries (128 jobs, both
    strands), with the engine that holds the DB's incidence; then the
    same chunk at m = 200 and at m = 0."""
    import numpy as np
    from usearch12_tpu_torch import cli
    from usearch12_tpu_torch.amplicon import sintax_device as sd
    q64 = os.path.join(d, "q64.fa")
    with open(qf) as f, open(q64, "w") as out:
        out.writelines(f.readlines()[:128])
    seen = []
    orig = sd.TorchBootEngine.run_chunk

    def grab(engine, *args):
        seen.append((engine, args))
        return orig(engine, *args)

    sd.TorchBootEngine.run_chunk = grab
    try:
        rc = cli.main(["-sintax", q64, "-db", dbf, "-strand", "both",
                       "-randseed", "1", "-quiet", "-sintax_device"])
    finally:
        sd.TorchBootEngine.run_chunk = orig
    if rc != 0 or len(seen) != 1:
        fail(f"sintax chunk capture: exit {rc}, {len(seen)} chunks")
    engine, (words, nuw, m, stream, rr) = seen[0]
    if words.shape[0] != 128 or int(m.min()) != 32:
        fail(f"sintax chunk capture: {words.shape} jobs, m {set(m)}")
    chunks = [(32, words, nuw, m, stream, rr)]
    for m_val, mmax in ((200, 256), (0, 8)):
        chunks.append((m_val, words, nuw, np.full_like(m, m_val),
                       lcg_stream(engine.B * mmax), rr))
    return engine, chunks


def check_sintax_kernels(engine, chunks, dev):
    """The SINTAX kernels against their plain versions on full chunks;
    returns times and errors of the m = 32 chunk and the worst error."""
    import torch
    from usearch12_tpu_torch.ops import sintax_boot as sb
    out = {"hist_err": 0.0, "select_err": 0.0}
    for m_val, words, nuw, m, stream, rr in chunks:
        words_d, nuw_d, m_d, stream_d, rr_d = (
            torch.from_numpy(x.view("int32")).to(dev)
            for x in (words, nuw, m, stream, rr))
        dtype = sb.product_dtype(dev, m_val * max(engine.inc_absmax, 1))
        args = (nuw_d, m_d, stream_d, engine.B, words.shape[1], dtype)
        hist_ms, P = cuda_ms(lambda: sb.pick_hist(*args), 5)
        hist_plain_ms, P_plain = cuda_ms(lambda: sb.pick_hist_plain(*args), 1)
        if not bit_equal(P, P_plain):
            fail(f"sintax m={m_val}: sintax_pick_hist differs from its "
                 "plain version")
        gather_ms, mq = cuda_ms(lambda: sb.gather_rows(
            engine.w_mat, words_d, nuw_d, dtype), 3)
        prod_ms, U = cuda_ms(lambda: sb.boot_product(P, mq), 3)
        del mq
        sel_ms, sel = cuda_ms(lambda: sb.boot_select(U, rr_d), 5)
        sel_plain_ms, sel_plain = cuda_ms(
            lambda: sb.boot_select_plain(U, rr_d), 1)
        for name, x, y in zip(("winner", "top"), sel, sel_plain):
            if not bit_equal(x, y):
                fail(f"sintax m={m_val}: sintax_boot_select {name} differs "
                     "from its plain version")
        top = int(sel[1].max())
        if m_val == 0 and top != 0:
            fail("sintax m=0: non-zero top")
        out["hist_err"] = max(out["hist_err"],
                              float((P - P_plain).abs().max()))
        out["select_err"] = max(out["select_err"], float(max(
            (x - y).abs().max() for x, y in zip(sel, sel_plain))))
        print(f"sintax kernels m={m_val}: {tuple(U.shape)} {dtype}; "
              f"sintax_pick_hist {hist_ms:.3f} ms, plain {hist_plain_ms:.3f}"
              f" ms; gather {gather_ms:.3f} ms; product {prod_ms:.3f} ms; "
              f"sintax_boot_select {sel_ms:.3f} ms, plain {sel_plain_ms:.3f}"
              f" ms; top max {top}; bit-equal to plain", flush=True)
        if m_val == 32:
            out.update(hist_ms=hist_ms, hist_plain_ms=hist_plain_ms,
                       sel_ms=sel_ms, sel_plain_ms=sel_plain_ms)
        del U, P, P_plain, sel_plain
    return out


def sintax_run(args, stats=None, profile=False):
    """Wall seconds of one in-process sintax run through the port's
    command line, with host-side stage times (classify_window and the
    chunks' run_chunk, synchronised) and, if asked, the device time by
    kernel from torch.profiler."""
    import torch
    from usearch12_tpu_torch import cli
    from usearch12_tpu_torch.amplicon import sintax_device as sd
    stage = {"classify_window": 0.0, "run_chunk": 0.0}
    orig = {"classify_window": sd.SintaxTorchClassifier.classify_window,
            "run_chunk": sd.TorchBootEngine.run_chunk}

    def timed(name):
        def f(*a, **k):
            t0 = time.perf_counter()
            r = orig[name](*a, **k)
            stage[name] += time.perf_counter() - t0
            return r
        return f

    sd.SintaxTorchClassifier.classify_window = timed("classify_window")
    sd.TorchBootEngine.run_chunk = timed("run_chunk")
    if stats:
        os.environ["USEARCH_DEVICE_STATS"] = stats
    prof = None
    try:
        if profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        rc = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        sd.SintaxTorchClassifier.classify_window = orig["classify_window"]
        sd.TorchBootEngine.run_chunk = orig["run_chunk"]
        os.environ.pop("USEARCH_DEVICE_STATS", None)
    if rc != 0:
        fail(f"usearch12_tpu_torch.cli -sintax exited {rc}")
    kernels = None
    if prof is not None:
        def dev_us(e):
            return getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))
        evs = sorted((e for e in prof.key_averages() if dev_us(e) > 0
                      and not e.key.startswith("aten::")),
                     key=dev_us, reverse=True)
        kernels = {"device_ms": round(sum(map(dev_us, evs)) / 1000, 3),
                   "top": [(e.key[:50], round(dev_us(e) / 1000, 3), e.count)
                           for e in evs[:8]]}
    return wall, stage, kernels


def gate_crossover(gate):
    """The target count at which host and card take equal time: host -
    card interpolated linearly between measured sizes (n, host s, card s),
    or extrapolated from the two nearest sizes when one side wins at
    every size; nan when the data give none."""
    pts = [(n, h - c) for n, h, c in gate]
    pairs = list(zip(pts, pts[1:]))
    for (n0, d0), (n1, d1) in pairs:
        if d0 <= 0 < d1:
            return n0 - d0 * (n1 - n0) / (d1 - d0)
    (n0, d0), (n1, d1) = pairs[0] if pts[0][1] > 0 else pairs[-1]
    if d1 > d0:
        return n0 - d0 * (n1 - n0) / (d1 - d0)
    return float("nan")


def phase_sintax(d, dev, phase_done):
    """Phases 6 and 7 in directory d; returns the kernel check's numbers
    and the launch counts of the main run."""
    import torch
    from usearch12_tpu_torch.ops import sintax_boot as sb

    # 6. the SINTAX kernels on full chunks of the workload
    t_phase = time.perf_counter()
    sizes_of = {}
    for n in (60000, 90000, 20000, 5000):
        dbf, qf = (os.path.join(d, f"sx{n}_{x}.fa") for x in ("db", "q"))
        gen_sintax(dbf, qf, n)
        sizes_of[n] = (dbf, qf)
    dbf, qf = sizes_of[60000]
    t0 = time.perf_counter()
    engine, chunks = sintax_chunks(dbf, qf, d)
    print(f"sintax chunk: 128 jobs x 256 slots from the port's run on 64 "
          f"queries in {time.perf_counter() - t0:.2f} s; incidence "
          f"{tuple(engine.w_mat.shape)} int8, max {engine.inc_absmax}",
          flush=True)
    sx = check_sintax_kernels(engine, chunks, dev)
    del engine, chunks
    torch.cuda.empty_cache()
    phase_done(6, t_phase)

    # 7. the workload through the port's command line against the JAX
    # package's host path, then the gate's measurement
    t_phase = time.perf_counter()
    base = ["-sintax", qf, "-db", dbf, "-strand", "both", "-randseed", "1",
            "-quiet"]
    ref, port = os.path.join(d, "ref.tab"), os.path.join(d, "port.tab")
    stats = os.path.join(d, "sintax_stats.jsonl")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "usearch12_tpu.cli"] + base
                       + ["-no_sintax_device", "-tabbedout", ref], cwd=HERE,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=900)
    t_host = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"sintax host judge exited {r.returncode}: {r.stderr[-2000:]}")
    sb.pick_hist.launches = 0
    sb.boot_select.launches = 0
    t_port, stage, _ = sintax_run(base + ["-sintax_device", "-tabbedout",
                                          port], stats)
    launches = {"sintax_pick_hist": sb.pick_hist.launches,
                "sintax_boot_select": sb.boot_select.launches}
    with open(ref, "rb") as f:
        ref_b = f.read()
    with open(port, "rb") as f:
        port_b = f.read()
    with open(stats) as f:
        rec = json.loads(f.read().splitlines()[-1])
    n_rows = ref_b.count(b"\n")
    with open(qf) as f:
        n_queries = f.read().count(">")
    print(f"sintax: 60,000 targets x 1,500 queries, -strand both; JAX host "
          f"path (subprocess) {t_host:.2f} s, port on the card "
          f"{t_port:.2f} s (classify_window {stage['classify_window']:.2f} "
          f"s, run_chunk {stage['run_chunk']:.2f} s); stats {rec}; "
          f"launches {launches}; {n_rows} rows, tabbedout "
          f"{'equal' if ref_b == port_b else 'DIFFERENT'}", flush=True)
    if ref_b != port_b or n_rows != n_queries:
        fail("sintax -tabbedout of the port differs from the host path")
    if not rec["device"]:
        fail("sintax did not run on the card")
    if min(launches.values()) <= 0:
        fail(f"a SINTAX kernel was not launched on the main path: "
             f"{launches}")

    # the auto gate: host and card as fresh processes of the port's
    # command line, as a user runs it, at three DB sizes, in the order
    # host, card, card, host
    for code in ("import usearch12_tpu_torch.cli", "import torch",
                 "import torch; torch.zeros(1, device='cuda')"):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], cwd=HERE, check=True,
                       timeout=300)
        print(f"sintax gate: python -c \"{code}\" "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    gate = []
    for n in sorted(sizes_of):
        g_db, g_q = sizes_of[n]
        secs = {"-no_sintax_device": [], "-sintax_device": []}
        outs = []
        for flag in ("-no_sintax_device", "-sintax_device", "-sintax_device",
                     "-no_sintax_device"):
            outs.append(os.path.join(d, f"gate{n}_{len(outs)}.tab"))
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "usearch12_tpu_torch.cli", "-sintax",
                 g_q, "-db", g_db, "-strand", "both", "-randseed", "1",
                 "-quiet", flag, "-tabbedout", outs[-1]],
                cwd=HERE, capture_output=True, text=True, timeout=600)
            secs[flag].append(time.perf_counter() - t0)
            if r.returncode != 0:
                fail(f"sintax gate {n} {flag} exited {r.returncode}: "
                     f"{r.stderr[-2000:]}")
        tabs = set()
        for out in outs:
            with open(out, "rb") as f:
                tabs.add(f.read())
        if len(tabs) != 1:
            fail(f"sintax gate {n}: host and card -tabbedout differ")
        host_s, card_s = (secs[k] for k in ("-no_sintax_device",
                                           "-sintax_device"))
        gate.append((n, sum(host_s) / 2, sum(card_s) / 2))
        print(f"sintax gate: {n} targets; host {host_s[0]:.2f}, "
              f"{host_s[1]:.2f} s, card {card_s[0]:.2f}, {card_s[1]:.2f} s; "
              "tabbedout equal", flush=True)
    print(f"sintax gate: crossover at {gate_crossover(gate):.0f} targets",
          flush=True)
    wall, stage, prof = sintax_run(base + ["-sintax_device", "-tabbedout",
                                           port], profile=True)
    print(f"sintax profile: wall {wall:.2f} s, classify_window "
          f"{stage['classify_window']:.2f} s, run_chunk "
          f"{stage['run_chunk']:.2f} s; {json.dumps(prof)}", flush=True)
    phase_done(7, t_phase)
    return sx, launches


def main():
    if not os.path.isdir(os.path.join(HERE, "usearch12_tpu_torch")):
        fail("run from a checkout of the repository (no "
             "usearch12_tpu_torch/ beside this script)")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    import numpy as np
    from usearch12_tpu_torch import _build, cli
    from usearch12_tpu_torch.device import card_info, resolve_device
    from usearch12_tpu_torch.ops import banded_nw as bn
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    from usearch12_tpu_torch.ops import wavefront_trace as wtr

    t_start = time.perf_counter()

    def phase_done(n, t0):
        print(f"phase {n}: {time.perf_counter() - t0:.1f} s (run "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    # 1. device
    dev = resolve_device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = card_info(0)
    print(f"device: {kind}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi, flush=True)
    phase_done(1, t_start)

    # 2. build
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.library_path().name} "
          f"{'reused' if cached else 'built'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_done(2, t0)

    # 3. kernels against their plain versions
    t_phase = time.perf_counter()
    ap = wnw.nucleo_params(-10.0, -1.0, -0.5, -0.5)     # the defaults
    ap_nd = wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4)  # non-dyadic
    rng = np.random.default_rng(7)
    pairs_a = kernel_pairs(rng, 65536, 250)
    check_kernels("250nt", pairs_a, 16, ap, dev, 5)
    big = check_kernels("3kb", kernel_pairs(rng, 512, 3000, indel=40), 120,
                        ap_nd, dev, 3)
    phase_done(3, t_phase)

    # 4. the device oracle: its kernels against their plain versions, then
    # BandedNWDevice judging the hole DP kernels on every pair of shape (a)
    t_phase = time.perf_counter()
    orc = check_banded("250nt", pairs_a, 16, ap, dev, 5)
    orc_wide = check_banded(
        "1kb", balanced_indel_pairs(np.random.default_rng(8), 2048, 1000),
        62, ap_nd, dev, 3)
    bn.banded_nw_fwd.launches = 0
    bn.banded_nw_chase.launches = 0
    t0 = time.perf_counter()
    s_orc, p_orc = bn.BandedNWDevice(ap, dev).align_device(pairs_a, 16)
    torch.cuda.synchronize()
    t_orc = time.perf_counter() - t0
    orc_launches = {"banded_nw_fwd": bn.banded_nw_fwd.launches,
                    "banded_nw_chase": bn.banded_nw_chase.launches}
    t0 = time.perf_counter()
    s_wave, p_wave = wnw.TorchWaveAligner(ap, dev).align(pairs_a, 16)
    t_wave = time.perf_counter() - t0
    n_diff = int(sum(1 for k in range(len(pairs_a))
                     if s_orc[k] != s_wave[k] or p_orc[k] != p_wave[k]))
    print(f"oracle judge: {len(pairs_a)} pairs of 250 nt; "
          f"BandedNWDevice.align_device {t_orc:.2f} s, "
          f"TorchWaveAligner.align {t_wave:.2f} s; launches {orc_launches}; "
          f"{n_diff} pairs differ; phase {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)
    if n_diff:
        fail(f"BandedNWDevice and TorchWaveAligner differ on {n_diff} pairs")
    if min(orc_launches.values()) <= 0:
        fail(f"a kernel was not launched on the oracle path: {orc_launches}")
    phase_done(4, t_phase)

    # 5. the slice: usearch_global on the long-contig workload
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        qf, tf = os.path.join(d, "lq.fa"), os.path.join(d, "lt.fa")
        gen_longseq(qf, tf)
        ref_b6, port_b6 = os.path.join(d, "ref.b6"), os.path.join(d,
                                                                 "port.b6")
        stats = os.path.join(d, "stats.jsonl")
        args = ["-usearch_global", qf, "-db", tf] + COMMON
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "usearch12_tpu.cli"]
                           + args + ["-no_engine_device", "-blast6out",
                                     ref_b6],
                           cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=900)
        t_host = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"host judge exited {r.returncode}: {r.stderr[-2000:]}")
        os.environ["USEARCH_DEVICE_STATS"] = stats
        wnw.wavefront_fwd.launches = 0
        wtr.wavefront_trace.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(args + ["-dev_batch_cells", "1", "-blast6out",
                              port_b6])
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
        launches = {"wavefront_fwd": wnw.wavefront_fwd.launches,
                    "wavefront_trace": wtr.wavefront_trace.launches}
        del os.environ["USEARCH_DEVICE_STATS"]
        if rc != 0:
            fail(f"usearch12_tpu_torch.cli exited {rc}")
        with open(ref_b6, "rb") as f:
            ref = f.read()
        with open(port_b6, "rb") as f:
            port = f.read()
        with open(stats) as f:
            ds = json.loads(f.read().splitlines()[-1])
        n_hits = ref.count(b"\n")
        print(f"slice: 32 x 32 contigs of 24,150 nt; host C path "
              f"{t_host:.2f} s, port {t_port:.2f} s; device_cells "
              f"{ds['device_cells']}, host_cells {ds['host_cells']}, "
              f"dispatches {ds['dispatches']}; launches {launches}; "
              f"{n_hits} hits, blast6 "
              f"{'equal' if ref == port else 'DIFFERENT'}", flush=True)
        if ref != port or n_hits == 0:
            fail("blast6 of the port differs from the host C path")
        if ds["device_cells"] <= 0:
            fail("no hole cells ran on the device")
        if min(launches.values()) <= 0:
            fail(f"a kernel was not launched on the main path: {launches}")
    phase_done(5, t_phase)
    del pairs_a, s_orc, p_orc, s_wave, p_wave
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        sx, sx_launches = phase_sintax(d, dev, phase_done)

    print(json.dumps({"kernels": [
        {"name": "wavefront_fwd", "route": "cuda",
         "source": "usearch12_tpu_torch/csrc/wavefront_fwd.cu",
         "replaces": "usearch12_tpu/ops/wavefront_nw.py:257",
         "launches": launches["wavefront_fwd"],
         "max_abs_err": big["fwd_err"], "ms": big["fwd_ms"],
         "plain_ms": big["fwd_plain_ms"]},
        {"name": "wavefront_trace", "route": "cuda",
         "source": "usearch12_tpu_torch/csrc/wavefront_trace.cu",
         "replaces": "usearch12_tpu/ops/wavefront_trace.py:54",
         "launches": launches["wavefront_trace"],
         "max_abs_err": big["trace_err"], "ms": big["trace_ms"],
         "plain_ms": big["trace_plain_ms"]},
        {"name": "banded_nw_fwd", "route": "cuda",
         "source": "usearch12_tpu_torch/csrc/banded_nw.cu",
         "replaces": "usearch12_tpu/ops/banded_nw.py:122",
         "launches": orc_launches["banded_nw_fwd"],
         "max_abs_err": max(orc["fwd_err"], orc_wide["fwd_err"]),
         "ms": orc["fwd_ms"], "plain_ms": orc["fwd_plain_ms"]},
        {"name": "banded_nw_chase", "route": "cuda",
         "source": "usearch12_tpu_torch/csrc/banded_nw.cu",
         "replaces": "usearch12_tpu/ops/banded_nw.py:569",
         "launches": orc_launches["banded_nw_chase"],
         "max_abs_err": max(orc["chase_err"], orc_wide["chase_err"]),
         "ms": orc["chase_ms"], "plain_ms": orc["chase_plain_ms"]},
        {"name": "sintax_pick_hist", "route": "cuda",
         "source": "usearch12_tpu_torch/csrc/sintax_boot.cu",
         "replaces": "usearch12_tpu/amplicon/sintax_device.py:132",
         "launches": sx_launches["sintax_pick_hist"],
         "max_abs_err": sx["hist_err"], "ms": sx["hist_ms"],
         "plain_ms": sx["hist_plain_ms"]},
        {"name": "sintax_boot_select", "route": "cuda",
         "source": "usearch12_tpu_torch/csrc/sintax_boot.cu",
         "replaces": "usearch12_tpu/amplicon/sintax_device.py:156",
         "launches": sx_launches["sintax_boot_select"],
         "max_abs_err": sx["select_err"], "ms": sx["sel_ms"],
         "plain_ms": sx["sel_plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
