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
     kernels' launch counts of that run.
The line before the last is the kernel summary as JSON, the last line
{"ok": true, "device": {...}}.
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

    # 1. device
    dev = resolve_device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = card_info(0)
    print(f"device: {kind}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.library_path().name} "
          f"{'reused' if cached else 'built'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    ap = wnw.nucleo_params(-10.0, -1.0, -0.5, -0.5)     # the defaults
    ap_nd = wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4)  # non-dyadic
    rng = np.random.default_rng(7)
    pairs_a = kernel_pairs(rng, 65536, 250)
    check_kernels("250nt", pairs_a, 16, ap, dev, 5)
    big = check_kernels("3kb", kernel_pairs(rng, 512, 3000, indel=40), 120,
                        ap_nd, dev, 3)

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

    # 5. the slice: usearch_global on the long-contig workload
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
         "ms": orc["chase_ms"], "plain_ms": orc["chase_plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
